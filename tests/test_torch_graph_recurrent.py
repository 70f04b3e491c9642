"""The recurrent side of the PyTorch port's `ComputationGraph` against
the JAX package, on the CPU: truncated BPTT over graph vertices,
`LastTimeStepVertex` and `DuplicateToTimeSeriesVertex`, and DL4J's
seq2seq graph (an encoder's last step broadcast over the decoder's
length, merged with the decoder's input), with JAX's weights carried
across (`params_from_numpy`).

Tolerances: losses 1e-5 relative, parameters 1e-5 absolute after the
fits (float32 sums in another order, compounding over Adam steps, as
`test_torch_recurrent.py` holds the sequential tBPTT fit); the vertices'
outputs and gradients 1e-6 (a gather and a broadcast: exact but for the
upstream float32)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn.graph as jgraph
from deeplearning4j_tpu.data.dataset import (
    DataSet as JaxDataSet, MultiDataSet as JaxMDS,
)
from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.inputs import InputType as JaxIT
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.optim.listeners import (
    CollectScoresIterationListener as JaxScores,
)
from deeplearning4j_tpu.optim.updaters import Adam as JaxAdam
import deeplearning4j_tpu_torch.nn.graph as pgraph
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener,
)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=0, atol=1e-5)
V, T = 7, 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree(port_tree, jax_tree, **tol):
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: a.detach().numpy(), port_tree))
    want = jax.tree_util.tree_leaves(_np(jax_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


def _port(jnet):
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    return pnet


def _lstm_graph(fwd, back=None):
    """The character model's chain (LSTM, GravesLSTM, softmax), narrow,
    as graph vertices under tBPTT(fwd, back)."""
    g = (JaxNNC.builder().seed(4).activation("tanh")
         .updater(JaxAdam(learning_rate=1e-2, epsilon=1e-3))
         .graph_builder().add_inputs("in")
         .set_input_types(JaxIT.recurrent(V, T)))
    g.add_layer("l0", jrec.LSTM(n_out=8), "in")
    g.add_layer("l1", jrec.GravesLSTM(n_out=8), "l0")
    g.add_layer("out", jrec.RnnOutputLayer(n_out=V, activation="softmax",
                                           loss="mcxent"), "l1")
    g.set_outputs("out")
    conf = g.tbptt(fwd, back).build()
    jnet = JaxGraph(conf).init()
    return jnet, _port(jnet)


def _batches(masked, n=2, b=3, seed=12):
    rng = np.random.default_rng(seed)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for i in range(n):
        ids = rng.integers(0, V, (b, T + 1))
        fm = None
        if masked and i == 1:
            fm = np.ones((b, T), np.float32)
            fm[0, 7:] = 0
            fm[2, 10:] = 0
        out.append((eye[ids[:, :T]], eye[ids[:, 1:]], fm))
    return out


@pytest.mark.parametrize("fwd,back,masked", [(4, None, False),
                                             (6, 3, False), (4, None, True)],
                         ids=["fwd4", "fwd6_back3", "fwd4_masked"])
def test_graph_tbptt_fit_matches_jax(fwd, back, masked):
    jnet, pnet = _lstm_graph(fwd, back)
    batches = _batches(masked)
    js, ps = JaxScores(), CollectScoresIterationListener()
    jnet.listeners.append(js)
    pnet.listeners.append(ps)
    jnet.fit([JaxDataSet(x, y, fm, fm) for x, y, fm in batches])
    pnet.fit([DataSet(x, y, fm, fm) for x, y, fm in batches])
    assert pnet.iteration == jnet.iteration == 2
    assert int(pnet._step_t) == 2
    np.testing.assert_allclose([s for _, s in ps.scores],
                               [s for _, s in js.scores], **LOSS_TOL)
    _assert_tree(pnet.params_tree, jnet.params_tree, **PARAM_TOL)
    _assert_tree(pnet.updater_state, jnet.updater_state, rtol=1e-4,
                 atol=1e-6)


def test_graph_tbptt_equals_the_sequential_fit():
    """The same layers as a MultiLayerNetwork: the same chunks, the same
    steps, the same parameters (the graph's vertices are the layers)."""
    jnet, pnet = _lstm_graph(4)
    seq_conf = (JaxNNC.builder().seed(4).activation("tanh")
                .updater(JaxAdam(learning_rate=1e-2, epsilon=1e-3))
                .list(*(jnet.conf.vertices[n].layer
                        for n in ("l0", "l1", "out")))
                .set_input_type(JaxIT.recurrent(V, T)).tbptt(4).build())
    seq = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        seq_conf.to_json()), device="cpu").init()
    assert sorted(seq.params_tree) == sorted(pnet.params_tree)
    params_from_numpy(seq, _np(jnet.params_tree))
    batches = [DataSet(x, y) for x, y, _ in _batches(False)]
    pnet.fit(batches)
    seq.fit(batches)
    for n, leaves in pnet.params_tree.items():
        for k, a in leaves.items():
            np.testing.assert_allclose(a.numpy(), seq.params_tree[n][k]
                                       .numpy(), rtol=0, atol=1e-6)


def test_graph_tbptt_refuses_sequence_labels_with_jax_message():
    jnet, pnet = _lstm_graph(4)
    x, _, _ = _batches(False, n=1)[0]
    y = np.zeros((3, V), np.float32)
    with pytest.raises(ValueError) as jerr:
        jnet.fit([JaxDataSet(x, y)])
    with pytest.raises(ValueError) as perr:
        pnet.fit([DataSet(x, y)])
    assert str(perr.value) == str(jerr.value)
    assert "per-timestep 3-D labels" in str(perr.value)


def test_graph_tbptt_runs_step_by_step_at_k4():
    _, a = _lstm_graph(4)
    _, b = _lstm_graph(4)
    batches = [DataSet(x, y) for x, y, _ in _batches(False, n=4)]
    a.fit(batches)
    b.fit(batches, steps_per_dispatch=4)
    assert b.fit_stats == {"graph_windows": 0, "eager_steps": 4}
    for n, leaves in a.params_tree.items():
        for k, t in leaves.items():
            assert torch.equal(b.params_tree[n][k], t), (n, k)


# ------------------------------------------------------------- the vertices
def _grad_pair(jfn, pfn, x, w):
    """(out, d sum(out * w) / dx) of a JAX and a port function."""
    jo, jvjp = jax.vjp(jfn, jnp.asarray(x))
    jg, = jvjp(jnp.asarray(w))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    po = pfn(xt)
    pg, = torch.autograd.grad((po * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_last_time_step_vertex_matches_jax(masked):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    m = None
    if masked:
        m = np.ones((4, 6), np.float32)
        m[1, 3:] = 0
        m[3, 1:] = 0
    jv = jgraph.LastTimeStepVertex(mask_input="in")
    pv = pgraph.LastTimeStepVertex(mask_input="in")
    jm = None if m is None else jnp.asarray(m)
    pm = None if m is None else torch.from_numpy(m)
    _grad_pair(lambda a: jv.apply({}, [a], mask=jm)[0],
               lambda a: pv.apply({}, [a], mask=pm)[0], x, w)
    assert pv.output_type(pgraph.InputType.recurrent(5, 6)) == \
        pgraph.InputType.feed_forward(5)


def test_duplicate_to_time_series_vertex_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    w = rng.standard_normal((3, 7, 5)).astype(np.float32)
    jv = jgraph.DuplicateToTimeSeriesVertex(timesteps=7)
    pv = pgraph.DuplicateToTimeSeriesVertex(timesteps=7)
    _grad_pair(lambda a: jv.apply({}, [a])[0],
               lambda a: pv.apply({}, [a])[0], x, w)
    assert pv.output_type(pgraph.InputType.feed_forward(5)) == \
        pgraph.InputType.recurrent(5, 7)


# ----------------------------------------------------------------- seq2seq
def _seq2seq_conf(te=5, td=4, f=6, hidden=8, vocab=6):
    """dl4j-examples' AdditionRNN graph, narrow: encoder GravesLSTM ->
    LastTimeStepVertex -> DuplicateToTimeSeriesVertex over the decoder's
    length -> MergeVertex with the decoder's input -> decoder GravesLSTM
    -> softmax per step."""
    g = (JaxNNC.builder().seed(6).activation("tanh")
         .updater(JaxAdam(learning_rate=1e-2))
         .graph_builder().add_inputs("enc_in", "dec_in")
         .set_input_types(JaxIT.recurrent(f, te), JaxIT.recurrent(f, td)))
    g.add_layer("encoder", jrec.GravesLSTM(n_out=hidden), "enc_in")
    g.add_vertex("last", jgraph.LastTimeStepVertex(mask_input="enc_in"),
                 "encoder")
    g.add_vertex("dup", jgraph.DuplicateToTimeSeriesVertex(timesteps=td),
                 "last")
    g.add_vertex("merge", jgraph.MergeVertex(), "dec_in", "dup")
    g.add_layer("decoder", jrec.GravesLSTM(n_out=hidden), "merge")
    g.add_layer("out", jrec.RnnOutputLayer(n_out=vocab, activation="softmax",
                                           loss="mcxent"), "decoder")
    g.set_outputs("out")
    return g.build()


def _s2s_batches(n=3, b=4, te=5, td=4, f=6, vocab=6, seed=8):
    rng = np.random.default_rng(seed)
    eye = np.eye(vocab, dtype=np.float32)
    out = []
    for _ in range(n):
        enc = eye[rng.integers(0, f, (b, te))]
        dec = eye[rng.integers(0, f, (b, td))]
        y = eye[rng.integers(0, vocab, (b, td))]
        out.append((enc, dec, y))
    return out


def test_seq2seq_json_both_ways():
    jconf = _seq2seq_conf()
    text = jconf.to_json()
    pconf = ComputationGraphConfiguration.from_json(text)
    assert pconf.to_json() == text
    assert jgraph.ComputationGraphConfiguration.from_json(
        pconf.to_json()).to_json() == text
    assert isinstance(pconf.vertices["dup"],
                      pgraph.DuplicateToTimeSeriesVertex)
    assert pconf.vertices["last"].mask_input == "enc_in"


def test_seq2seq_graph_three_steps_match_jax():
    jnet = JaxGraph(_seq2seq_conf()).init()
    pnet = _port(jnet)
    batches = _s2s_batches()
    js, ps = JaxScores(), CollectScoresIterationListener()
    jnet.listeners.append(js)
    pnet.listeners.append(ps)
    jnet.fit([JaxMDS([e, d], [y]) for e, d, y in batches])
    pnet.fit([MultiDataSet([e, d], [y]) for e, d, y in batches])
    assert pnet.iteration == jnet.iteration == 3
    np.testing.assert_allclose([s for _, s in ps.scores],
                               [s for _, s in js.scores], **LOSS_TOL)
    _assert_tree(pnet.params_tree, jnet.params_tree, **PARAM_TOL)
    e, d, _ = batches[0]
    np.testing.assert_allclose(pnet.output(e, d).numpy(),
                               np.asarray(jnet.output(e, d)), rtol=1e-5,
                               atol=1e-5)


def test_seq2seq_k4_equals_k1():
    jnet = JaxGraph(_seq2seq_conf()).init()
    a, b = _port(jnet), _port(jnet)
    batches = [MultiDataSet([e, d], [y])
               for e, d, y in _s2s_batches(n=4, seed=9)]
    a.fit(batches)
    b.fit(batches, steps_per_dispatch=4)
    assert a.iteration == b.iteration == 4
    for n, leaves in a.params_tree.items():
        for k, t in leaves.items():
            assert torch.equal(b.params_tree[n][k], t), (n, k)
