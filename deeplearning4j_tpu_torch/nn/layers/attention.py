"""Attention layers — port of `deeplearning4j_tpu/nn/layers/attention.py`:
RoPE, `MultiHeadAttention` (full-context `apply` and `_decode`, per-slot
and lockstep), `PositionEmbeddingLayer` and `TransformerEncoderBlock`
(layer/RMS norm, GELU/SwiGLU FFN).

Two decode carry layouts, as in JAX: a per-slot carry (`per_slot=True`,
the serving sessions) holds a [B] position vector, and a lockstep carry
(`per_slot=False`, the default: `rnn_time_step`, `generate`,
`beam_search`) one 0-d position shared by every row. The lockstep step
runs the per-slot code with its position broadcast to [B] and returns
a 0-d position; its `mask` is ignored, as JAX ignores it. Its overflow
guard is the NaN poison in the graph and the runtime's host-side budget
(`models/multilayer._check_decode_budget`): `_decode` never reads a
position on the host.

Per-slot decode updates the KV caches IN PLACE. JAX threads the carries
functionally; at full width a slot's cache is tens of MB per layer, so
the port writes this step's K/V straight into the pool's tensors and
returns the same tensors in the new carry. That is sound because a
token that must not write — padding in a prefill chunk, an inactive
lane (the session runtime folds `active` into the mask), a position past
a linear cache — never reaches the cache: its write is routed to a drop
row that lives in the cache's storage just past its last row (see
`new_kv_cache`), the counterpart of JAX's `mode="drop"` scatter, with
no data-dependent shape and no host sync. Quantized carries
(`kv_dtype="int8"` or `"fp8"`) store int8 or e4m3 codes with one float32
scale per (token, kv head); the scale rows ride the same drop-row
scatter, and the decode kernels dequantize them on load.

Full-context `apply` routes through `kernel_defaults.attention_policy`
as JAX's does: with no padding mask and no attention dropout, a sliding
window calls the banded kernel B4 (`ops/banded_attention.
banded_attention`) on the native Hkv layout, and a full context the
flash kernels (`ops/attention.flash_attention`, B3a forward and B3b/B3c
backward) after the GQA broadcast; otherwise the dense masked softmax,
which also applies attention dropout.

Not ported yet: MoE blocks and the sequence-parallel ring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, keep_mask, register_layer,
)
from deeplearning4j_tpu_torch.ops import banded_attention as ba
from deeplearning4j_tpu_torch.ops.attention import flash_attention
from deeplearning4j_tpu_torch.ops.kernel_defaults import attention_policy

_NEG = -1e30


def rope_rotate(x, positions, base: float = 10000.0):
    """Rotary position embedding: rotate [B, T, H, Dh] per-head pairs by
    position-dependent angles. `positions` is [T] or [B, T] (per-slot
    offsets)."""
    dh = x.shape[-1]
    if dh % 2:
        raise ValueError(f"RoPE needs an even head dim, got {dh}")
    half = dh // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    if ang.ndim == 2:                  # [T, half] -> [1, T, half]
        ang = ang[None]
    c = torch.cos(ang)[:, :, None, :].to(x.dtype)
    s = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def new_kv_cache(shape, dtype, device) -> torch.Tensor:
    """A zeroed [N, L, ...] cache (K/V [N, L, Hkv, Dh] or scale rows
    [N, L, Hkv]) whose storage holds one more row past its end: the drop
    row that writes which must not land (padding, inactive lanes,
    overflow) are routed to. The tensor itself is an ordinary contiguous
    view of the first N * L rows, so kernels and readers never see the
    extra row."""
    n0, n1, *rest = shape
    row = math.prod(rest)
    buf = torch.zeros((n0 * n1 + 1) * row, dtype=dtype, device=device)
    return buf[:n0 * n1 * row].view(n0, n1, *rest)


def _cache_rows(cache: torch.Tensor) -> torch.Tensor:
    """[N * L + 1, row] view over a cache's storage, drop row last."""
    n0, n1 = cache.shape[:2]
    row = math.prod(cache.shape[2:])
    need = (cache.storage_offset() + (n0 * n1 + 1) * row) \
        * cache.element_size()
    if not cache.is_contiguous() or \
            cache.untyped_storage().nbytes() < need:
        raise ValueError("decode caches must come from new_kv_cache (a "
                         "contiguous cache with its drop row)")
    return cache.as_strided((n0 * n1 + 1, row), (row, 1))


def write_kv(cache: torch.Tensor, flat_rows: torch.Tensor,
             vals: torch.Tensor) -> None:
    """In-place scatter of `vals` [M, ...] into cache rows `flat_rows`
    [M] (row N * L = the drop row)."""
    rows = _cache_rows(cache)
    vals = vals.reshape(-1, rows.shape[1]).to(cache.dtype)
    if cache.dtype == torch.float8_e4m3fn:
        # e4m3 codes move as their bytes (index_copy_ has no e4m3 kernel
        # on every device)
        rows, vals = rows.view(torch.uint8), vals.view(torch.uint8)
    rows.index_copy_(0, flat_rows, vals)


# storage dtype of each quantized KV dtype, and its largest code
KV_QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def quantize_kv(val, dtype):
    """Quantize-on-write, as JAX's `_decode` does it: one float32 scale
    per (token, kv head) — the row's amax over the head dim divided by
    the format's largest code (127 for int8, 448 for e4m3), 1 for an
    all-zero row so dequantizing stays finite — and codes val / scale,
    rounded half to even and clipped to ±127 for int8, cast for e4m3.
    val [.., Hkv, Dh] -> (codes [.., Hkv, Dh] in `dtype`, scales
    [.., Hkv] float32)."""
    qmax = _QMAX[dtype]
    amax = val.abs().amax(dim=-1)
    sc = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    scaled = val.float() / sc.float()[..., None]
    if dtype == torch.int8:
        codes = torch.clamp(torch.round(scaled), -127.0, 127.0).to(dtype)
    else:
        codes = scaled.to(dtype)
    return codes, sc.float()


@register_layer
@dataclasses.dataclass(frozen=True)
class MultiHeadAttention(Layer):
    """Self-attention over [batch, time, features]; `num_kv_heads <
    num_heads` is grouped-query attention (the cache holds Hkv heads)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    num_heads: int = 4
    num_kv_heads: Optional[int] = None
    causal: bool = False
    attn_dropout: float = 0.0
    max_cache: int = 1024
    rope: bool = False
    window: Optional[int] = None
    rolling_cache: bool = False

    def infer_n_in(self, input_type: InputType):
        upd = {}
        if self.n_in is None:
            upd["n_in"] = input_type.size
        if self.n_out is None:
            upd["n_out"] = upd.get("n_in", self.n_in)
        return dataclasses.replace(self, **upd) if upd else self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    @property
    def _kv_heads(self) -> int:
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)

    def _check_heads(self):
        H, Hkv = self.num_heads, self._kv_heads
        if self.n_out % H:
            raise ValueError(
                f"n_out {self.n_out} not divisible by num_heads {H}")
        if not 1 <= Hkv <= H or H % Hkv:
            raise ValueError(
                f"num_kv_heads {Hkv} must divide num_heads {H}")

    def init_params(self, gen, input_type, dtype=torch.float32):
        d = self.n_out
        self._check_heads()
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.rolling_cache:
            if self.window is None or not self.causal:
                raise ValueError(
                    "rolling_cache needs causal=True and a window")
            if self.max_cache < self.window:
                raise ValueError(
                    f"rolling_cache: max_cache {self.max_cache} < window "
                    f"{self.window}; the buffer cannot hold the band")
        dkv = self._kv_heads * (d // self.num_heads)
        winit = self._winit()
        return {
            "Wq": winit(gen, (self.n_in, d), dtype),
            "Wk": winit(gen, (self.n_in, dkv), dtype),
            "Wv": winit(gen, (self.n_in, dkv), dtype),
            "Wo": winit(gen, (d, d), dtype),
            "b": torch.zeros((d,), dtype=dtype),
        }, {}

    def decode_carry(self, batch: int, dtype=torch.float32, *,
                     per_slot: bool = False, kv_dtype: str = None,
                     page_len: int = None, pages: int = None,
                     device=None):
        """Decode carry: [batch, max_cache, Hkv, Dh] caches (or, with
        `page_len`, a pool of `pages` [page_len, Hkv, Dh] pages plus a
        [batch, max_cache / page_len] int32 page table) and an int32
        position: 0-d for a lockstep carry (the default), [batch] for a
        per-slot one (`per_slot=True`, which needs causal attention).
        Caches come from `new_kv_cache`. `kv_dtype` "int8" or "fp8"
        stores int8 or e4m3 codes with float32 scale rows
        `scale_k`/`scale_v` of the caches' [N, L, Hkv]; quantized and
        paged carries are per-slot only."""
        quant = kv_dtype in KV_QUANT
        if not quant and kv_dtype not in (None, "native"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        if quant and not per_slot:
            raise ValueError(
                "quantized KV carries are a session-pool feature "
                "(per_slot=True); the lockstep rnn_time_step path stays "
                "native")
        if page_len is not None and not per_slot:
            raise ValueError("paged KV carries are a session-pool feature "
                             "(per_slot=True)")
        if per_slot and not self.causal:
            raise ValueError("per-slot decode carries need causal=True")
        cdt = KV_QUANT[kv_dtype] if quant else dtype
        Dh = self.n_out // self.num_heads
        L = self.max_cache
        Hkv = self._kv_heads
        pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                          device=device)
        if page_len is not None:
            if self.rolling_cache:
                raise ValueError(
                    "paged KV carries cannot ride a rolling ring")
            if page_len < 1 or L % page_len:
                raise ValueError(
                    f"max_cache {L} not divisible by page_len {page_len}")
            npg = L // page_len
            P = int(pages) if pages is not None else batch * npg
            if P < npg:
                raise ValueError(
                    f"page pool of {P} pages cannot hold even one slot's "
                    f"{npg} logical pages")
            rows = (P, page_len)
        else:
            rows = (batch, L)
        carry = {"cache_k": new_kv_cache((*rows, Hkv, Dh), cdt, device),
                 "cache_v": new_kv_cache((*rows, Hkv, Dh), cdt, device)}
        if page_len is not None:
            carry["page_table"] = torch.zeros((batch, npg),
                                              dtype=torch.int32,
                                              device=device)
        carry["pos"] = pos
        if quant:
            carry.update(
                scale_k=new_kv_cache((*rows, Hkv), torch.float32, device),
                scale_v=new_kv_cache((*rows, Hkv), torch.float32, device))
        return carry

    def _decode(self, params, x, state, mask=None):
        """One decode step: write this chunk's K/V at the carry's
        position (in place), attend every query over its visible cache.
        A per-slot carry ([B] `pos`) steps each slot at its own position:
        `mask` [B, T] marks the valid prefix of a padded chunk, and
        invalid tokens do not write and do not advance the position. A
        lockstep carry (0-d `pos`) steps every row together, as JAX's
        scalar branch: `mask` is ignored, the position is broadcast to
        [B] for the shared code, and the new position stays 0-d. A
        paged carry addresses logical position j at physical row
        `page_table[j // Lp]`, offset `j % Lp`. A single-token step goes
        through the decode kernel (B6 paged, B5 otherwise); longer
        chunks attend densely under the same visibility rules. A
        quantized carry (`scale_k` in the state) quantizes on write and
        dequantizes on read."""
        B, T, _ = x.shape
        H = self.num_heads
        Hkv = self._kv_heads
        Dh = self.n_out // H
        paged = "page_table" in state
        quant = "scale_k" in state
        ck, cv = state["cache_k"], state["cache_v"]
        if paged:
            if self.rolling_cache:
                raise ValueError(
                    "paged KV caches cannot ride a rolling ring")
            pt = state["page_table"]
            npg = pt.shape[1]
            P, Lp = ck.shape[0], ck.shape[1]
            L = npg * Lp
        else:
            L = ck.shape[1]
        if self.rolling_cache:
            if T + self.window - 1 > L:
                raise ValueError(
                    f"rolling decode step of {T} tokens needs max_cache "
                    f">= {T + self.window - 1} (window {self.window}), "
                    f"have {L}")
        elif T > L:
            raise ValueError(f"decode step of {T} tokens > max_cache {L}")
        pos0 = state["pos"]
        lockstep = pos0.ndim == 0
        if lockstep:
            if paged:
                raise ValueError("paged KV caches require per-slot mode")
            if quant:
                raise ValueError(
                    "quantized KV carries require per-slot mode")
            mask = None
            pos = pos0.expand(B).contiguous()
        else:
            if not self.causal:
                raise ValueError("per-slot decode needs causal=True")
            pos = pos0
        dev = x.device

        q = (x @ params["Wq"]).reshape(B, T, H, Dh)
        k = (x @ params["Wk"]).reshape(B, T, Hkv, Dh)
        v = (x @ params["Wv"]).reshape(B, T, Hkv, Dh)
        valid = None if mask is None else (mask > 0)
        n_new = (torch.full((B,), T, dtype=pos.dtype, device=dev)
                 if valid is None else valid.sum(dim=1, dtype=pos.dtype))
        q_ids = pos.long()[:, None] + torch.arange(T, device=dev)  # [B, T]
        if self.rope:
            q = rope_rotate(q, q_ids)
            k = rope_rotate(k, q_ids)

        # ---- cache write (in place; dropped writes go to the drop row)
        tgt = torch.remainder(q_ids, L) if self.rolling_cache else q_ids
        ok = tgt < L
        if valid is not None:
            ok = ok & valid
        if paged:
            page = torch.gather(pt.long(), 1,
                                torch.clamp(tgt // Lp, 0, npg - 1))
            flat = page * Lp + torch.remainder(tgt, Lp)
            drop = P * Lp
        else:
            flat = torch.arange(B, device=dev)[:, None] * L + tgt
            drop = B * L
        flat = torch.where(ok, flat, torch.full_like(flat, drop)).reshape(-1)
        sk = sv = None
        if quant:
            # quantize-on-write; the scale rows take the caches' scatter
            sk, sv = state["scale_k"], state["scale_v"]
            kq, k_sc = quantize_kv(k, ck.dtype)
            vq, v_sc = quantize_kv(v, cv.dtype)
            write_kv(ck, flat, kq)
            write_kv(cv, flat, vq)
            write_kv(sk, flat, k_sc)
            write_kv(sv, flat, v_sc)
        else:
            write_kv(ck, flat, k)
            write_kv(cv, flat, v)

        if not self.rolling_cache:
            # per-row overflow poison: a chunk past a linear cache is
            # NaN, not silently wrong (its writes were dropped above)
            q = torch.where((pos + n_new <= L)[:, None, None, None], q,
                            torch.full_like(q, float("nan")))

        # the newest position each slot holds after this chunk's writes
        end = pos + n_new - 1
        if T == 1:
            # the decode kernel: launched on a CUDA tensor (which raises
            # rather than fall back), its plain version on a CPU one
            q1 = q[:, 0].contiguous()
            qpos = pos.to(torch.int32)
            # (B5q/B6q over quantized caches: dequantized on load)
            if paged:
                o = ba.paged_decode_attention(q1, ck, cv, pt.to(torch.int32),
                                              qpos, window=self.window,
                                              scale_k=sk, scale_v=sv)
            else:
                o = ba.banded_decode_attention(
                    q1, ck, cv, qpos,
                    (end if self.rolling_cache else pos).to(torch.int32),
                    window=self.window, rolling=self.rolling_cache,
                    scale_k=sk, scale_v=sv)
            o = o[:, None]
        else:
            # a prefill chunk: the decode kernels' visibility rules, one
            # query row a token, over the whole (logical) cache,
            # dequantized on read in q's dtype
            def logical(c):
                return ba.gather_pages(c, pt) if paged else c

            kk, vv = logical(ck), logical(cv)
            if quant:
                kk = ba.dequantize(kk, logical(sk), q.dtype)
                vv = ba.dequantize(vv, logical(sv), q.dtype)
            if self.causal:
                vis = ba.visibility(q_ids, end, L, self.window,
                                    self.rolling_cache)
            else:
                # lockstep, bidirectional (JAX's scalar branch): the
                # written prefix, and |i - j| < window
                j = torch.arange(L, device=dev)
                qe = q_ids[..., None]
                vis = (j < (pos + T)[:, None, None]).expand(B, T, L)
                if self.window is not None:
                    vis = vis & (j > qe - self.window) & \
                        (j < qe + self.window)
            o = ba.attend_plain(q, kk, vv, vis)
        y = o.reshape(B, T, self.n_out) @ params["Wo"] + params["b"]
        new_state = {"cache_k": ck, "cache_v": cv,
                     "pos": pos0 + T if lockstep else pos + n_new}
        if paged:
            new_state["page_table"] = pt
        if quant:
            new_state["scale_k"], new_state["scale_v"] = sk, sv
        return self._act(y), new_state

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        if state is not None and "cache_k" in state:
            return self._decode(params, x, state, mask=mask)
        B, T, _ = x.shape
        H = self.num_heads
        Hkv = self._kv_heads
        Dh = self.n_out // H
        q = (x @ params["Wq"]).reshape(B, T, H, Dh)
        k = (x @ params["Wk"]).reshape(B, T, Hkv, Dh)
        v = (x @ params["Wv"]).reshape(B, T, Hkv, Dh)
        if self.rope:
            positions = torch.arange(T, device=x.device)
            q = rope_rotate(q, positions)
            k = rope_rotate(k, positions)
        drop = (self.attn_dropout
                if train and self.attn_dropout and rng is not None else 0.0)
        pol = attention_policy(device=x.device, masked=mask is not None,
                               dropout=bool(drop), window=self.window,
                               head_dim=Dh)
        if pol.kind == "banded":
            # B4 reads the native Hkv layout: no broadcast
            o = ba.banded_attention(q, k, v, self.window, self.causal)
        else:
            if Hkv != H:
                # GQA: broadcast the KV heads up to the query heads for
                # the H-wide attention cores (flash and dense), as JAX
                # does
                k = torch.repeat_interleave(k, H // Hkv, dim=2)
                v = torch.repeat_interleave(v, H // Hkv, dim=2)
            if pol.kind == "flash":
                o = flash_attention(q, k, v, self.causal)
            else:
                o = self._masked_attention(q, k, v, mask, self.causal,
                                           dropout=drop, rng=rng,
                                           window=self.window)
        y = o.reshape(B, T, self.n_out) @ params["Wo"] + params["b"]
        return self._act(y), state

    @staticmethod
    def _masked_attention(q, k, v, mask, causal=False, dropout=0.0,
                          rng=None, window=None):
        """Dense full-context attention with additive -1e30 biases for
        the padding mask, the causal band and the sliding window, and
        inverted dropout on the attention weights (post-softmax, pre-V),
        drawn from the generator `rng`."""
        d = q.shape[-1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        tq, tk = s.shape[-2], s.shape[-1]
        bias = torch.zeros((), dtype=s.dtype, device=s.device)
        if mask is not None:
            bias = torch.where(mask[:, None, None, :] > 0, 0.0, _NEG)
        qi = torch.arange(tq, device=s.device)[:, None]
        ki = torch.arange(tk, device=s.device)[None, :]
        if causal:
            bias = bias + torch.where(ki <= qi, 0.0, _NEG)
        if window is not None:
            local = (ki > qi - window) if causal else \
                ((qi - ki).abs() < window)
            bias = bias + torch.where(local, 0.0, _NEG)
        p = torch.softmax(s + bias, dim=-1)
        if dropout:
            keep = 1.0 - dropout
            kept = keep_mask(p.shape, keep, rng, p.device)
            p = torch.where(kept, p / keep, torch.zeros((), dtype=p.dtype,
                                                        device=p.device))
        return torch.einsum("bhqk,bkhd->bqhd", p, v)


@register_layer
@dataclasses.dataclass(frozen=True)
class PositionEmbeddingLayer(Layer):
    """Learned absolute position embedding added to [B, T, d]."""

    CONSUMES = "rnn"

    max_length: int = 512
    n_out: Optional[int] = None

    def infer_n_in(self, input_type: InputType):
        if self.n_out is None:
            return dataclasses.replace(self, n_out=input_type.size)
        return self

    def init_params(self, gen, input_type, dtype=torch.float32):
        d = self.n_out or input_type.size
        return {"P": 0.02 * torch.randn((self.max_length, d), generator=gen,
                                        dtype=torch.float32).to(dtype)}, {}

    def decode_carry(self, batch: int, dtype=torch.float32, *,
                     per_slot: bool = False, kv_dtype: str = None,
                     page_len: int = None, pages: int = None, device=None):
        # no KV here — the KV options are accepted (and ignored) so the
        # session-carry builder can pass one policy to every decode layer
        return {"pos": torch.zeros((batch,) if per_slot else (),
                                   dtype=torch.int32, device=device)}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        t = x.shape[1]
        if t > self.max_length:
            raise ValueError(f"sequence length {t} > max_length "
                             f"{self.max_length}")
        if state is not None and "pos" in state:
            pos = state["pos"]
            offs = torch.arange(t, device=x.device)
            if pos.ndim == 0:
                # lockstep: every row at the same offset; `mask` ignored
                positions = pos.long() + offs
                p = params["P"][torch.clamp(positions,
                                            max=self.max_length - 1)]
                p = torch.where(pos + t <= self.max_length, p,
                                torch.full_like(p, float("nan")))
                return x + p[None], {"pos": pos + t}
            valid = None if mask is None else (mask > 0)
            n_new = (torch.full_like(pos, t) if valid is None
                     else valid.sum(dim=1, dtype=pos.dtype))
            positions = pos.long()[:, None] + offs
            p = params["P"][torch.clamp(positions, max=self.max_length - 1)]
            # per-row overflow poison
            p = torch.where((pos + n_new <= self.max_length)[:, None, None],
                            p, torch.full_like(p, float("nan")))
            return x + p, {"pos": pos + n_new}
        return x + params["P"][None, :t, :], state


@register_layer
@dataclasses.dataclass(frozen=True)
class TransformerEncoderBlock(Layer):
    """Pre-norm transformer block: x + MHA(norm(x)), then x + FFN(norm(x)).
    `norm="rms"` and `ffn_activation="swiglu"` (with rope and GQA) give
    the Llama block shape. MoE FFNs (`n_experts > 0`) are not ported."""

    CONSUMES = "rnn"

    n_in: Optional[int] = None
    num_heads: int = 4
    num_kv_heads: Optional[int] = None
    ffn_mult: int = 4
    causal: bool = True
    n_experts: int = 0
    moe_k: int = 2
    max_cache: int = 1024
    rope: bool = False
    norm: str = "layer"
    ffn_activation: str = "gelu"
    window: Optional[int] = None
    rolling_cache: bool = False

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.size)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def _sub(self) -> MultiHeadAttention:
        if self.n_experts > 0:
            raise NotImplementedError("MoE transformer blocks are not "
                                      "ported yet")
        d = self.n_in
        return MultiHeadAttention(
            n_in=d, n_out=d, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, causal=self.causal,
            activation="identity", weight_init=self.weight_init,
            max_cache=self.max_cache, rope=self.rope, window=self.window,
            rolling_cache=self.rolling_cache)

    def init_params(self, gen, input_type, dtype=torch.float32):
        d = self.n_in
        if self.norm not in ("layer", "rms"):
            raise ValueError(f"norm must be 'layer' or 'rms', "
                             f"got {self.norm!r}")
        if self.ffn_activation not in ("gelu", "swiglu"):
            raise ValueError(f"ffn_activation must be 'gelu' or 'swiglu', "
                             f"got {self.ffn_activation!r}")
        attn = self._sub()
        params = {"ln1_g": torch.ones((d,), dtype=dtype),
                  "ln2_g": torch.ones((d,), dtype=dtype)}
        if self.norm == "layer":
            params["ln1_b"] = torch.zeros((d,), dtype=dtype)
            params["ln2_b"] = torch.zeros((d,), dtype=dtype)
        ap, _ = attn.init_params(gen, input_type, dtype)
        params.update({f"attn_{k}": v for k, v in ap.items()})
        h = self.ffn_mult * d
        winit = self._winit()
        params.update({
            "ffn_w1": winit(gen, (d, h), dtype),
            "ffn_b1": torch.zeros((h,), dtype=dtype),
            "ffn_w2": winit(gen, (h, d), dtype),
            "ffn_b2": torch.zeros((d,), dtype=dtype),
        })
        if self.ffn_activation == "swiglu":
            params["ffn_w3"] = winit(gen, (d, h), dtype)
        return params, {}

    def _norm_apply(self, x, params, prefix):
        g = params[f"{prefix}_g"]
        if self.norm == "rms":
            ms = torch.mean(x * x, dim=-1, keepdim=True)
            return x * torch.rsqrt(ms + 1e-5) * g
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + 1e-5) * g + params[f"{prefix}_b"]

    def decode_carry(self, batch: int, dtype=torch.float32, *,
                     per_slot: bool = False, kv_dtype: str = None,
                     page_len: int = None, pages: int = None, device=None):
        return {"attn": self._sub().decode_carry(
            batch, dtype, per_slot=per_slot, kv_dtype=kv_dtype,
            page_len=page_len, pages=pages, device=device)}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        attn = self._sub()
        ap = {k[5:]: v for k, v in params.items() if k.startswith("attn_")}
        h = self._norm_apply(x, params, "ln1")
        attn_carry = state.get("attn") if state else None
        a, a_st = attn.apply(ap, h, state=attn_carry, train=train, rng=rng,
                             mask=mask)
        x = x + a
        h = self._norm_apply(x, params, "ln2")
        if self.ffn_activation == "swiglu":
            gate = torch.nn.functional.silu(h @ params["ffn_w1"]
                                            + params["ffn_b1"])
            y = (gate * (h @ params["ffn_w3"])) @ params["ffn_w2"] \
                + params["ffn_b2"]
        else:
            y = torch.nn.functional.gelu(h @ params["ffn_w1"]
                                         + params["ffn_b1"],
                                         approximate="tanh")
            y = y @ params["ffn_w2"] + params["ffn_b2"]
        y = self._maybe_dropout(y, train, rng)
        new_state = {"attn": a_st} if attn_carry is not None else {}
        return x + y, new_state
