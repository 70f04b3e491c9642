"""`generate` and `beam_search` of the PyTorch port over attention stacks
against the JAX package, on the CPU, in float64, on weights copied from
JAX: greedy and beam (width 1 and 4, an EOS, the length penalty) token
for token on both runtimes and on both example flows' configurations
(`examples/transformer_text_generation.py`,
`examples/modern_llm_decode.py`, cut to tiny widths); nucleus and top-k
sampling by their invariants (the two packages' draws differ); the
`rng=` keyword (F2); the validation order and the refusal of
multi-input graphs."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.utils.textgen import (
    beam_search as jax_beam_search, generate as jax_generate,
)
from deeplearning4j_tpu_torch.utils.textgen import beam_search, generate

from torch_stepping_pairs import RUNTIMES, pair, tgt_conf

EXAMPLES = ("text_generation", "modern_llm")


def _prompt(seed, b=2, t=4, vocab=11):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("config", EXAMPLES)
@pytest.mark.parametrize("chunk", [None, 3])
def test_greedy_generate_matches_jax(config, runtime, chunk):
    jnet, pnet = pair(tgt_conf(config, T=16), runtime)
    prompt = _prompt(1)
    want = jax_generate(jnet, prompt, 10, greedy=True, prefill_chunk=chunk)
    got = generate(pnet, prompt, 10, greedy=True, prefill_chunk=chunk)
    np.testing.assert_array_equal(got, want)


BEAMS = [(1, 0.6, None), (4, 0.0, None), (4, 0.6, None), (4, 0.0, "first")]


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("config", EXAMPLES)
@pytest.mark.parametrize("width,penalty,eos", BEAMS,
                         ids=["w1", "w4", "w4-penalty", "w4-eos"])
def test_beam_search_matches_jax(config, runtime, width, penalty, eos):
    jnet, pnet = pair(tgt_conf(config, T=16), runtime)
    prompt = _prompt(2)
    if eos == "first":
        # the token greedy emits first: the best beam finishes at once
        eos = int(jax_generate(jnet, prompt, 1, greedy=True)[0, 0])
    want = jax_beam_search(jnet, prompt, 8, beam_width=width,
                           length_penalty=penalty, eos_id=eos)
    got = beam_search(pnet, prompt, 8, beam_width=width,
                      length_penalty=penalty, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    if width == 1:
        np.testing.assert_array_equal(
            got, generate(pnet, prompt, 8, greedy=True))


def test_beam_search_on_a_ring_matches_jax():
    """A rolling cache streams past its ring; beam reorders gather it."""
    jnet, pnet = pair(tgt_conf("ring", T=12))
    prompt = _prompt(3, t=6)
    np.testing.assert_array_equal(
        beam_search(pnet, prompt, 20, beam_width=3, prefill_chunk=4),
        jax_beam_search(jnet, prompt, 20, beam_width=3, prefill_chunk=4))


def _warped(p, temperature, top_k, top_p):
    """The sampling distribution's support: temperature, then top-k,
    then the smallest nucleus reaching top_p (stable order)."""
    w = p ** (1.0 / temperature)
    w = w / w.sum()
    order = np.argsort(-w, kind="stable")
    keep = np.zeros_like(w, dtype=bool)
    if top_k is not None:
        order = order[:top_k]
        w = np.where(np.isin(np.arange(len(w)), order), w, 0.0)
        w = w / w.sum()
    c = np.cumsum(w[order])
    n = len(order) if top_p is None else int(np.searchsorted(c, top_p)) + 1
    keep[order[:n]] = True
    return keep


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("knobs", [dict(top_p=0.9), dict(top_k=3),
                                   dict(top_k=4, top_p=0.8)],
                         ids=["nucleus", "top_k", "both"])
def test_sampling_stays_in_its_support(knobs, runtime):
    """Each sampled token lies in its step's warped support, computed
    from the teacher-forced probabilities of the stream itself; the
    stream is fixed by its seed (or by `rng`)."""
    _, pnet = pair(tgt_conf("modern_llm", T=16), runtime)
    prompt = _prompt(4)
    got = generate(pnet, prompt, 12, temperature=0.9,
                   rng=np.random.default_rng(0), **knobs)
    again = generate(pnet, prompt, 12, temperature=0.9,
                     rng=np.random.default_rng(0), **knobs)
    np.testing.assert_array_equal(got, again)
    stream = np.concatenate([prompt, got], axis=1)
    probs = pnet.output(stream[:, :, None].astype(np.float64)).numpy()
    for b in range(stream.shape[0]):
        for i in range(got.shape[1]):
            p = probs[b, prompt.shape[1] - 1 + i]
            assert _warped(p, 0.9, knobs.get("top_k"),
                           knobs.get("top_p"))[got[b, i]], (b, i)


def test_rng_keyword_is_accepted_and_seed_kept():
    """F2: JAX's `rng=` keyword (a numpy Generator) works, as the
    nucleus call of `examples/modern_llm_decode.py` passes it; `seed=`
    stays; both at once is refused."""
    _, pnet = pair(tgt_conf("modern_llm", T=16))
    prompt = _prompt(5)
    a = generate(pnet, prompt, 6, top_p=0.9, rng=np.random.default_rng(7))
    b = generate(pnet, prompt, 6, top_p=0.9, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(a, b)
    seed = int(np.random.default_rng(7).integers(1 << 32))
    np.testing.assert_array_equal(
        a, generate(pnet, prompt, 6, top_p=0.9, seed=seed))
    with pytest.raises(TypeError, match="not both"):
        generate(pnet, prompt, 2, seed=1, rng=np.random.default_rng(0))


@pytest.mark.parametrize("kw,match", [
    (dict(top_k=0, top_p=2.0), "top_k"),
    (dict(top_p=2.0, repetition_penalty=0.5), "top_p"),
    (dict(repetition_penalty=0.5, temperature=0.0), "repetition_penalty"),
    (dict(temperature=0.0), "temperature")])
def test_validation_order_is_jaxs(kw, match):
    jnet, pnet = pair(tgt_conf("text_generation", T=8))
    prompt = _prompt(6)
    with pytest.raises(ValueError, match=match):
        jax_generate(jnet, prompt, 2, **kw)
    with pytest.raises(ValueError, match=match):
        generate(pnet, prompt, 2, **kw)


def test_beam_validation_and_empty_output():
    _, pnet = pair(tgt_conf("text_generation", T=8))
    with pytest.raises(ValueError, match="beam_width"):
        beam_search(pnet, np.zeros((1, 2), np.int64), 2, beam_width=0)
    assert beam_search(pnet, np.zeros((2, 2), np.int64), 0,
                       eos_id=1).shape == (2, 0)


def test_multi_io_graphs_and_other_objects_are_refused():
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import MergeVertex
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        EmbeddingSequenceLayer, RnnOutputLayer,
    )

    g = (NeuralNetConfiguration.builder().graph_builder()
         .add_inputs("a", "b")
         .set_input_types(InputType.recurrent(1, 4),
                          InputType.recurrent(1, 4)))
    g.add_layer("ea", EmbeddingSequenceLayer(n_in=7, n_out=4), "a")
    g.add_layer("eb", EmbeddingSequenceLayer(n_in=7, n_out=4), "b")
    g.add_vertex("m", MergeVertex(), "ea", "eb")
    g.add_layer("out", RnnOutputLayer(n_out=7, activation="softmax"), "m")
    g.set_outputs("out")
    net = ComputationGraph(g.build(), device="cpu").init()
    with pytest.raises(ValueError, match="exactly one network input"):
        generate(net, np.zeros((1, 2), np.int64), 2)
    with pytest.raises(TypeError, match="MultiLayerNetwork or "
                                        "ComputationGraph"):
        generate(torch.nn.Linear(2, 2), np.zeros((1, 2), np.int64), 2)


def test_the_example_flows_run_on_the_port():
    """`examples/transformer_text_generation.py`'s and
    `examples/modern_llm_decode.py`'s flows with the port's imports, at
    tiny widths and a few epochs: fit on a repeating corpus, then greedy,
    nucleus (with `rng=`) and beam decoding through the KV caches."""
    from deeplearning4j_tpu_torch.data import (
        ArrayDataSetIterator, DataSet,
    )
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    corpus = "the more he saw the less he spoke. " * 8
    chars = sorted(set(corpus))
    idx = {c: i for i, c in enumerate(chars)}
    ids = np.array([idx[c] for c in corpus])
    T, V = 16, len(chars)
    starts = np.arange(32)
    x = np.stack([ids[s:s + T] for s in starts])[..., None].astype(
        np.float32)
    y = np.eye(V, dtype=np.float32)[
        np.stack([ids[s + 1:s + T + 1] for s in starts])]
    prompt = np.array([[idx[c] for c in "the more"]])
    for kw in (dict(), dict(num_kv_heads=2, pos_encoding="rope",
                            norm="rms", ffn_activation="swiglu",
                            max_decode=T + 8)):
        net = TextGenerationTransformer(
            num_classes=V, input_shape=(T, 1), d_model=16, num_heads=4,
            num_blocks=2, **kw).init(device="cpu")
        first = net.score(DataSet(x, y))
        for _ in range(3):
            net.fit(ArrayDataSetIterator(x, y, batch_size=16))
        assert net.score(DataSet(x, y)) < first
        n = 8           # the learned table's 16 positions hold 8 + 8
        outs = [generate(net, prompt, n, greedy=True),
                generate(net, prompt, n, temperature=0.9, top_p=0.9,
                         rng=np.random.default_rng(0)),
                beam_search(net, prompt, n, beam_width=4,
                            length_penalty=0.0)]
        for out in outs:
            assert out.shape == (1, n) and 0 <= out.min() and out.max() < V
