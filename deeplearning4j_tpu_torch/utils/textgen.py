"""Autoregressive text generation via stateful stepping (port of
`deeplearning4j_tpu/utils/textgen.py`): the helpers the session manager
uses, and `generate()` over a recurrent `MultiLayerNetwork`'s
`rnn_time_step`, so a prompt is consumed once and each new token costs
one step. Stochastic draws use the port's own counter-based generator
(`utils/sampling.py`): token i of row b draws with the counter i, so a
stream is determined by its seed; greedy output matches the JAX package
token for token. `beam_search()` is not ported yet."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.sampling import (
    SamplingParams, lane_param_arrays, sample_token_lanes,
)


def _resolve_net(net):
    """(first_layer, vocab) of a MultiLayerNetwork."""
    if not hasattr(net, "layers"):
        raise TypeError(f"decode needs a MultiLayerNetwork, got "
                        f"{type(net).__name__}")
    return net.layers[0], net.layers[-1].n_out


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
             seed: int = 0) -> np.ndarray:
    """Sample `n_tokens` continuations of `prompt_ids` ([B, Tp] ints).

    The network's output layer must produce per-timestep class
    probabilities (softmax). Decoding controls compose as in the JAX
    package: `repetition_penalty` > 1 raises the probabilities of tokens
    already in the prompt or generated so far to that power before
    renormalization, then `temperature`, `top_k` and `top_p` warp the
    distribution (`utils.sampling`); `greedy` takes the argmax after the
    repetition penalty. `seed` keys the counter-based draws (the JAX
    package takes a numpy Generator here; the two do not give the same
    samples). Returns the sampled ids, [B, n_tokens]."""
    prompt_ids = np.asarray(prompt_ids)
    if prompt_ids.ndim == 1:
        prompt_ids = prompt_ids[None, :]
    if repetition_penalty < 1.0:
        raise ValueError(
            f"repetition_penalty must be >= 1, got {repetition_penalty}")
    params = SamplingParams(temperature=temperature, top_k=top_k,
                            top_p=top_p, greedy=greedy)
    B = prompt_ids.shape[0]
    first_layer, vocab = _resolve_net(net)
    encoding = _input_encoding(first_layer)
    dev = net.device
    temps, tks, tps, grdy = (
        torch.as_tensor(a, device=dev)
        for a in lane_param_arrays([params] * B, vocab))
    keys = torch.tensor([[int(seed) & 0xFFFFFFFF, b] for b in range(B)],
                        dtype=torch.int64, device=dev)
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
            x = (tok[:, None, None].to(net.dtype) if encoding == "ids" else
                 torch.nn.functional.one_hot(tok, vocab).to(net.dtype)[:, None])
            out = net.rnn_time_step(x)
    return generated.cpu().numpy()
