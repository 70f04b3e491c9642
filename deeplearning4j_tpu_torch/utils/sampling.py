"""Token sampling for the decode window (port of
`deeplearning4j_tpu/utils/sampling.py`, device dialect).

Same knobs and truncation semantics as the JAX package — temperature in
log space (skipped at exactly 1.0), stable-order top-k (ties: first
occurrence wins), nucleus top-p keeping the token that crosses the
threshold, greedy = first-occurrence argmax of the raw probabilities —
so greedy output matches the JAX package token for token.

Stochastic draws use the port's own counter-based generator: a 32-bit
integer hash of (the lane's two seed words, the token's index in the
stream), computed on the device with int64 arithmetic that never
overflows. Token i of a session always draws from the counter i, so a
stream is determined by its seed and does not depend on the window
length K or on which sessions share a dispatch. The draws are not JAX's
threefry draws; the two packages agree on invariants, not on samples.

`spec_accept_lanes` is the speculative window's accept/reject: greedy
lanes agree with the JAX package exactly, stochastic lanes keep the
target's distribution (the acceptance uniforms are an argument).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B          # < 2**27: a [0, 2**32) value times it fits int64


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs, validated at construction."""

    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: bool = False

    def __post_init__(self):
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature <= 0.0:
            raise ValueError(
                f"temperature must be > 0, got {self.temperature}")


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash on int64 tensors holding [0, 2**32) values."""
    x = x & _M32
    x = (((x >> 16) ^ x) * _MUL) & _M32
    x = (((x >> 16) ^ x) * _MUL) & _M32
    return (x >> 16) ^ x


def lane_uniforms(keys: torch.Tensor, counters: torch.Tensor,
                  salt: int = 0) -> torch.Tensor:
    """One uniform float32 in [0, 1) per lane from its seed words `keys`
    [S, 2] (int64 holding uint32 values) and its draw counter `counters`
    [S]: a pure function of (seed, counter), on the tensors' device. A
    nonzero `salt` selects a stream independent of the sampling one (the
    speculative window's acceptance and residual draws)."""
    h = _mix32(keys[:, 0] ^ 0x9E3779B9)
    h = _mix32(h ^ keys[:, 1])
    if salt:
        h = _mix32(h ^ salt)
    h = _mix32(h ^ _mix32(counters + 0x632BE5AB))
    h = _mix32(h ^ 0x85EBCA6B)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def warp_probs_lanes(probs, temperature, top_k, top_p):
    """Temperature, top-k and top-p over [S, V] probabilities, per lane:
    the distribution a stochastic lane samples from, zeroed outside the
    truncation sets and not renormalized (the draw is scale-invariant)."""
    p = probs.to(torch.float32)
    t = temperature[:, None].to(torch.float32)
    tempered = torch.softmax(torch.log(torch.clamp(p, min=1e-30)) / t,
                             dim=-1)
    p = torch.where(t == 1.0, p, tempered)
    # one stable descending sort serves both knobs (ties keep vocabulary
    # order, as the JAX package's argsort does)
    sorted_p, order = torch.sort(p, dim=-1, descending=True, stable=True)
    idx = torch.arange(p.shape[-1], device=p.device)[None, :]
    sorted_p = torch.where(idx < top_k[:, None], sorted_p,
                           torch.zeros_like(sorted_p))
    csum = torch.cumsum(sorted_p, dim=-1)
    keep = (csum - sorted_p) < top_p[:, None] * csum[:, -1:]
    kept = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    return torch.zeros_like(p).scatter_(-1, order, kept)


def sample_token_lanes(probs, temperature, top_k, top_p, greedy, keys,
                       counters):
    """Per-lane next token from [S, V] probabilities, on the device.
    Greedy lanes take the first-occurrence argmax of the raw
    probabilities; the others draw by inverse CDF from the warped
    distribution with the uniform of (keys, counters). Returns int64[S].
    """
    greedy_tok = torch.argmax(probs.to(torch.float32), dim=-1)
    w = warp_probs_lanes(probs, temperature, top_k, top_p)
    drawn = draw_lanes(w, lane_uniforms(keys, counters))
    return torch.where(greedy, greedy_tok, drawn)


def draw_lanes(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw of one token per lane from unnormalized [S, V]
    weights `w` with the uniforms `u` [S]: the first index whose cdf
    exceeds u times the mass (zero-weight tokens share their
    predecessor's cdf value and can never be drawn)."""
    cdf = torch.cumsum(w, dim=-1)
    r = u[:, None] * cdf[:, -1:]
    return torch.clamp((cdf <= r).sum(dim=-1), max=w.shape[-1] - 1)


def spec_accept_lanes(p_raw, p_warp, q_warp, draft_toks, greedy, uniforms,
                      extra_u):
    """Accept/reject of one speculative window on the device (S lanes,
    k draft tokens, V vocabulary):

    - `p_raw` f32[S, k+1, V]: the target's raw probabilities at each
      chunk position (position i conditions on [t0, d_1..d_i]);
    - `p_warp` f32[S, k+1, V]: the same after `warp_probs_lanes`;
    - `q_warp` f32[S, k, V]: the draft's warped probabilities each d_i
      was drawn from;
    - `draft_toks` int[S, k]; `greedy` bool[S];
    - `uniforms` f32[S, k]: the acceptance draws, from a stream
      independent of both models' sampling streams;
    - `extra_u` f32[S]: the uniform of the residual or bonus draw.

    Greedy lanes take the longest prefix of drafts equal to the target's
    raw argmax; the extra token is the argmax at the first mismatch (the
    bonus token when every draft matched). Stochastic lanes accept d_i
    with probability min(1, p(d_i)/q(d_i)) on the warped, renormalised
    pair; at the first rejection the extra token is drawn from
    normalize(max(p - q, 0)), from p where the residual has no mass, and
    after full acceptance from the target's last position. Every lane
    yields n_acc accepted drafts plus one extra token, as the JAX
    package's `spec_accept_lanes` does (its extra draw is a threefry
    categorical; here an inverse CDF over `extra_u`).

    Returns (n_acc int64[S], extra int64[S])."""
    S, k1, V = p_raw.shape
    k = k1 - 1
    d = draft_toks.to(torch.int64)

    def norm(p):
        return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)

    # greedy: the longest prefix matching the raw argmax
    tgt = torch.argmax(p_raw, dim=-1)                           # [S, k+1]
    n_acc_g = torch.cumprod((tgt[:, :k] == d).to(torch.int64),
                            dim=1).sum(dim=1)
    extra_g = torch.gather(tgt, 1, n_acc_g[:, None])[:, 0]

    # stochastic: the rejection rule on the warped, renormalised pair
    pn, qn = norm(p_warp.to(torch.float32)), norm(q_warp.to(torch.float32))
    p_d = torch.gather(pn[:, :k], 2, d[:, :, None])[:, :, 0]     # [S, k]
    q_d = torch.gather(qn, 2, d[:, :, None])[:, :, 0]
    ok = uniforms * torch.clamp(q_d, min=1e-30) < p_d
    n_acc_s = torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)
    # the residual at the first rejection; q is zero past k, so full
    # acceptance draws the bonus token from p
    q_pad = torch.cat([qn, torch.zeros_like(qn[:, :1])], dim=1)
    at = n_acc_s[:, None, None].expand(S, 1, V)
    p_at = torch.gather(pn, 1, at)[:, 0]
    q_at = torch.gather(q_pad, 1, at)[:, 0]
    res = torch.clamp(p_at - q_at, min=0.0)
    res = torch.where(res.sum(dim=-1, keepdim=True) > 0.0, res, p_at)
    extra_s = draw_lanes(res, extra_u)
    return (torch.where(greedy, n_acc_g, n_acc_s),
            torch.where(greedy, extra_g, extra_s))


def lane_param_arrays(params_list, vocab):
    """Pack per-lane SamplingParams (None for inactive lanes) into the
    arrays `sample_token_lanes` takes; disabled knobs use their identity
    encodings (tau = 1, k = V, p = 1), inactive lanes are greedy."""
    n = len(params_list)
    temperature = np.ones((n,), np.float32)
    top_k = np.full((n,), int(vocab), np.int32)
    top_p = np.ones((n,), np.float32)
    greedy = np.ones((n,), bool)
    for i, sp in enumerate(params_list):
        if sp is None:
            continue
        temperature[i] = sp.temperature
        top_k[i] = int(vocab) if sp.top_k is None else min(sp.top_k, vocab)
        top_p[i] = 1.0 if sp.top_p is None else sp.top_p
        greedy[i] = bool(sp.greedy)
    return temperature, top_k, top_p, greedy
