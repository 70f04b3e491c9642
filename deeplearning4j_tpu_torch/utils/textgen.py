"""Autoregressive text generation via stateful stepping (port of
`deeplearning4j_tpu/utils/textgen.py`): the helpers the session manager
uses, `generate()` and `beam_search()`, over the `rnn_time_step` of a
`MultiLayerNetwork` or of a single-input, single-output
`ComputationGraph`, recurrent or attention stacks alike (LSTM h/c
carries, or lockstep KV caches), so a prompt is consumed once and each
new token costs one step. Stochastic draws use the port's own
counter-based generator (`utils/sampling.py`): token i of row b draws
with the counter i, so a stream is determined by its seed; greedy and
beam output match the JAX package token for token."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.sampling import (
    SamplingParams, lane_param_arrays, sample_token_lanes,
)


def _resolve_net(net):
    """(first_layer, vocab) for a MultiLayerNetwork or a single-input /
    single-output ComputationGraph (the two shapes `rnn_time_step` can
    drive one autoregressive stream through)."""
    if hasattr(net, "layers"):            # MultiLayerNetwork
        return net.layers[0], net.layers[-1].n_out
    conf = getattr(net, "conf", None)
    if conf is None or not hasattr(conf, "network_inputs"):
        raise TypeError(
            f"generate() needs a MultiLayerNetwork or ComputationGraph, "
            f"got {type(net).__name__}")
    if len(conf.network_inputs) != 1 or len(conf.network_outputs) != 1:
        raise ValueError(
            "generate() drives one autoregressive stream: the graph must "
            "have exactly one network input and one output (got "
            f"{list(conf.network_inputs)} -> "
            f"{list(conf.network_outputs)}); drive multi-IO graphs "
            "through rnn_time_step directly")
    # first layer = first layer-bearing vertex downstream of the input
    frontier = {conf.network_inputs[0]}
    first = None
    for name in conf.topological_order:
        if frontier & set(conf.vertex_inputs.get(name, ())):
            lyr = getattr(conf.vertices[name], "layer", None)
            if lyr is not None:
                first = lyr
                break
            frontier.add(name)           # pass-through vertex: keep walking
    if first is None:
        raise ValueError("no layer vertex found downstream of the "
                         "network input")
    out_v = conf.vertices[conf.network_outputs[0]]
    vocab = getattr(getattr(out_v, "layer", None) or out_v, "n_out", None)
    if vocab is None:
        raise ValueError(
            f"output vertex {conf.network_outputs[0]!r} has no n_out; "
            "generate() needs a per-timestep classification head")
    return first, vocab


def _input_encoding(first_layer) -> str:
    """'ids' for embedding-fronted stacks ([B, T, 1] token ids), 'onehot'
    for vocab-width inputs ([B, T, V])."""
    from deeplearning4j_tpu_torch.nn.layers import EmbeddingSequenceLayer

    return ("ids" if isinstance(first_layer, EmbeddingSequenceLayer)
            else "onehot")


def _encode(ids: np.ndarray, encoding: str, vocab: int) -> np.ndarray:
    """ids: [B, T] -> model input [B, T, 1] or one-hot [B, T, V]."""
    if encoding == "ids":
        return ids[..., None].astype(np.float32)
    return np.eye(vocab, dtype=np.float32)[ids]


def _prefill(net, prompt_ids, encoding, vocab, chunk: Optional[int]):
    """Feed the prompt through the stateful stepper, optionally in
    fixed-size chunks (bounds prefill memory). Returns the last chunk's
    output, on the net's device."""
    if chunk is None or prompt_ids.shape[1] <= chunk:
        return net.rnn_time_step(_encode(prompt_ids, encoding, vocab))
    if chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {chunk}")
    out = None
    for s in range(0, prompt_ids.shape[1], chunk):
        out = net.rnn_time_step(
            _encode(prompt_ids[:, s:s + chunk], encoding, vocab))
    return out


def generate(net, prompt_ids, n_tokens: int, *, temperature: float = 1.0,
             greedy: bool = False, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             repetition_penalty: float = 1.0,
             prefill_chunk: Optional[int] = None,
             rng: Optional[np.random.Generator] = None,
             seed: Optional[int] = None) -> np.ndarray:
    """Sample `n_tokens` continuations of `prompt_ids` ([B, Tp] ints).

    The network's output layer must produce per-timestep class
    probabilities (softmax). Decoding controls compose as in the JAX
    package: `repetition_penalty` > 1 raises the probabilities of tokens
    already in the prompt or generated so far to that power before
    renormalization, then `temperature`, `top_k` and `top_p` warp the
    distribution (`utils.sampling`); `greedy` takes the argmax after the
    repetition penalty. `prefill_chunk` feeds the prompt in chunks of
    that many tokens (bounds prefill memory; lets a rolling-cache net
    take a prompt longer than its ring holds in one step). The draws are
    keyed by `seed`, or by a seed drawn from the numpy Generator `rng`
    (the JAX package draws from `rng` itself; the two do not give the
    same samples); neither given: seed 0. Returns the sampled ids,
    [B, n_tokens]."""
    prompt_ids = np.asarray(prompt_ids)
    if prompt_ids.ndim == 1:
        prompt_ids = prompt_ids[None, :]
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if repetition_penalty < 1.0:
        raise ValueError(
            f"repetition_penalty must be >= 1, got {repetition_penalty}")
    if rng is not None and seed is not None:
        raise TypeError("pass seed= or rng=, not both")
    B = prompt_ids.shape[0]
    first_layer, vocab = _resolve_net(net)
    encoding = _input_encoding(first_layer)
    if rng is not None:
        seed = int(rng.integers(1 << 32))
    params = SamplingParams(temperature=temperature, top_k=top_k,
                            top_p=top_p, greedy=greedy)
    dev = net.device
    temps, tks, tps, grdy = (
        torch.as_tensor(a, device=dev)
        for a in lane_param_arrays([params] * B, vocab))
    keys = torch.tensor([[int(seed or 0) & 0xFFFFFFFF, b]
                         for b in range(B)], dtype=torch.int64, device=dev)
    penalize = repetition_penalty != 1.0
    if penalize:
        seen = torch.zeros((B, vocab), dtype=torch.bool, device=dev)
        seen.scatter_(1, torch.as_tensor(prompt_ids.astype(np.int64) % vocab,
                                         device=dev), True)
    net.rnn_clear_previous_state()
    out = _prefill(net, prompt_ids, encoding, vocab, prefill_chunk)
    generated = torch.empty((B, n_tokens), dtype=torch.int64, device=dev)
    for i in range(n_tokens):
        p = out[:, -1, :].to(torch.float64)
        if penalize:
            # floor after the power too: a huge penalty can underflow every
            # seen probability to 0, and the renormalization would divide
            # by zero once all tokens are seen
            p = torch.where(seen, torch.clamp(torch.pow(
                torch.clamp(p, min=1e-30), repetition_penalty), min=1e-300),
                p)
            p = p / p.sum(dim=-1, keepdim=True)
        tok = sample_token_lanes(
            p, temps, tks.to(torch.int64), tps, grdy, keys,
            torch.full((B,), i, dtype=torch.int64, device=dev))
        generated[:, i] = tok
        if penalize:
            seen[torch.arange(B, device=dev), tok] = True
        if i + 1 < n_tokens:
            out = net.rnn_time_step(_encode_tokens(tok, encoding, vocab,
                                                   net.dtype))
    return generated.cpu().numpy()


def _encode_tokens(tok: torch.Tensor, encoding: str, vocab: int, dtype):
    """Device token ids [B] as one step's model input [B, 1, F]."""
    if encoding == "ids":
        return tok[:, None, None].to(dtype)
    return torch.nn.functional.one_hot(tok, vocab).to(dtype)[:, None]


def _host_probs(out) -> np.ndarray:
    """The last step's probabilities [B, V] on the host (bfloat16 as
    float32)."""
    t = out[:, -1, :].detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def beam_search(net, prompt_ids, n_tokens: int, *, beam_width: int = 4,
                length_penalty: float = 0.6,
                eos_id: Optional[int] = None,
                prefill_chunk: Optional[int] = None) -> np.ndarray:
    """Beam-search decoding over the same stateful stepping as
    `generate`, with the JAX package's algorithm and host-side
    bookkeeping. The prompt is prefilled ONCE per batch row; the carries
    are then tiled to the beams (`net.rnn_reorder_state`) and gathered to
    each beam's chosen parent on reselection (skipped when every beam
    kept its own), so no prefix is ever recomputed. Each step's
    probabilities come to the host for a stable top-W over [B, W*V].

    Scores are sum-of-log-probs normalized by the GNMT length penalty
    ((5+len)/6)^alpha with alpha=`length_penalty` (0 disables). With
    `eos_id`, finished beams stop growing (further steps append eos at
    no cost) and the best-scoring finished-or-final beam wins. Returns
    [B, n_tokens] ids (the best beam per batch row, padded with eos
    after finish)."""
    prompt_ids = np.asarray(prompt_ids)
    if prompt_ids.ndim == 1:
        prompt_ids = prompt_ids[None, :]
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    B = prompt_ids.shape[0]
    W = beam_width
    if n_tokens < 1:
        return np.zeros((B, 0), dtype=np.int64)
    first_layer, vocab = _resolve_net(net)
    encoding = _input_encoding(first_layer)

    net.rnn_clear_previous_state()
    # prefill once per row, then tile the carries to the W beams
    out = _host_probs(_prefill(net, prompt_ids, encoding, vocab,
                               prefill_chunk))
    net.rnn_reorder_state(np.repeat(np.arange(B), W))
    # every beam of a row starts from the same distribution: [B, 1, V]
    # broadcasts against the [B, W] scores
    logp_next = np.log(np.maximum(out, 1e-30))[:, None, :]

    scores = np.full((B, W), -np.inf)
    scores[:, 0] = 0.0        # identical beams: expand only beam 0 first
    tokens = np.zeros((B, W, n_tokens), dtype=np.int64)
    done = np.zeros((B, W), dtype=bool)
    identity = np.arange(B * W)

    def _norm(s, length):
        if not length_penalty:
            return s
        return s / (((5.0 + length) / 6.0) ** length_penalty)

    for t in range(n_tokens):
        cand = scores[:, :, None] + logp_next            # [B, W, V]
        if eos_id is not None:
            # finished beams extend ONLY with eos, at no cost
            frozen = np.full((vocab,), -np.inf)
            frozen[eos_id] = 0.0
            cand = np.where(done[:, :, None],
                            scores[:, :, None] + frozen[None, None], cand)
        flat = np.broadcast_to(cand, (B, W, vocab)).reshape(B, W * vocab)
        top = np.argsort(-flat, axis=-1, kind="stable")[:, :W]
        parent = top // vocab                            # [B, W]
        tok = top % vocab
        scores = np.take_along_axis(flat, top, axis=-1)
        tokens = np.take_along_axis(tokens, parent[:, :, None], axis=1)
        tokens[:, :, t] = tok
        done = np.take_along_axis(done, parent, axis=1)
        if eos_id is not None:
            done = done | (tok == eos_id)
        # reorder the carries to the chosen parents (skip the identity:
        # a full cache gather per token moves every cache byte for
        # nothing), then step
        flat_idx = (np.arange(B)[:, None] * W + parent).reshape(-1)
        if not np.array_equal(flat_idx, identity):
            net.rnn_reorder_state(flat_idx)
        if t + 1 < n_tokens and not done.all():
            out = _host_probs(net.rnn_time_step(
                _encode(tok.reshape(-1, 1), encoding, vocab)))
            logp_next = np.log(np.maximum(out, 1e-30)).reshape(
                B, W, vocab)
    if eos_id is not None:
        finished = (tokens == eos_id).any(-1)
        lengths = np.where(finished,
                           np.argmax(tokens == eos_id, axis=-1) + 1,
                           n_tokens)
    else:
        lengths = np.full((B, W), n_tokens)
    best = np.argmax(_norm(scores, lengths), axis=-1)    # [B]
    return tokens[np.arange(B), best]
