"""The port's evaluation (`eval/`, copied from the JAX package) and the
`evaluate*` methods of both runtimes against the JAX package, on the CPU.

On the same seeded predictions, `Evaluation` (confusion matrix, every
averaged and per-class figure, `stats()`, `merge`, per-example meta
records, time-series labels with a mask), `EvaluationBinary`,
`RegressionEvaluation`, `ROC`, `ROCBinary` and `ROCMultiClass` give
JAX's figures and text exactly: the same numpy code on the same arrays.
On a LeNet and on a small graph with JAX's weights carried across,
`evaluate`, `evaluate_regression`, `evaluate_roc` and
`evaluate_roc_multi_class` give JAX's confusion matrix exactly and its
ROC and regression figures within 1e-6 absolute (float32 outputs within
1e-5 of JAX's, taken in another summation order); `evaluate` reads only
class indices off the device for plain labels (the full output never
crosses to the host)."""

import numpy as np
import pytest

import jax

import deeplearning4j_tpu.eval as jeval
from deeplearning4j_tpu.data.iterators import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.zoo import models as jax_zoo
import deeplearning4j_tpu_torch.eval as peval
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy,
)
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.zoo import models as zoo

FIG_TOL = dict(rtol=0, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _probs(rng, n, k):
    z = rng.standard_normal((n, k))
    p = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    return p.astype(np.float32)


def _onehot(rng, n, k):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]


def _figures(ev, k):
    out = [ev.accuracy(), ev.precision(), ev.recall(), ev.f1(),
           ev.precision(averaging="micro"), ev.recall(averaging="micro"),
           ev.f_beta(0.5), ev.g_measure(), ev.get_top_n_confusions(3)]
    for c in range(k):
        out += [ev.precision(c), ev.recall(c), ev.f1(c),
                ev.false_positive_rate(c), ev.matthews_correlation(c)]
    return out


def _both(name, *args, **kw):
    return getattr(peval, name)(*args, **kw), getattr(jeval, name)(*args, **kw)


def test_evaluation_figures_and_stats_match_jax():
    rng = np.random.default_rng(0)
    pe, je = _both("Evaluation", labels=["a", "b", "c", "d"])
    for _ in range(3):
        y, p = _onehot(rng, 40, 4), _probs(rng, 40, 4)
        pe.eval(y, p)
        je.eval(y, p)
    np.testing.assert_array_equal(pe.confusion.matrix, je.confusion.matrix)
    assert _figures(pe, 4) == _figures(je, 4)
    assert pe.stats() == je.stats()
    assert pe.confusion.matrix.sum() == 120


def test_evaluation_merge_meta_and_time_series_match_jax():
    rng = np.random.default_rng(1)
    parts = []
    for side in (peval, jeval):
        a, b = side.Evaluation(), side.Evaluation()
        meta = [side.RecordMetaData("rows.csv", i) for i in range(30)]
        y, p = _onehot(rng, 30, 3), _probs(rng, 30, 3)
        a.eval(y, p, record_meta=meta)
        ys, ps = _onehot(rng, 24, 3).reshape(4, 6, 3), _probs(
            rng, 24, 3).reshape(4, 6, 3)
        mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
        b.eval(ys, ps, mask=mask)
        a.merge(b)
        parts.append((a.confusion.matrix, _figures(a, 3), a.stats(),
                      [(q.actual, q.predicted, q.record_meta.location)
                       for q in a.get_prediction_errors()],
                      len(a.get_predictions_by_actual_class(1))))
        rng = np.random.default_rng(1)
    (pm, *prest), (jm, *jrest) = parts
    np.testing.assert_array_equal(pm, jm)
    assert prest == jrest


def test_binary_regression_and_roc_evaluators_match_jax():
    rng = np.random.default_rng(2)
    pb, jb = _both("EvaluationBinary")
    pr, jr = _both("RegressionEvaluation")
    proc, jroc = _both("ROC", 20)
    pbin, jbin = _both("ROCBinary")
    pmc, jmc = _both("ROCMultiClass")
    for _ in range(2):
        yb = (rng.random((25, 3)) > 0.5).astype(np.float32)
        sb = rng.random((25, 3)).astype(np.float32)
        yr = rng.standard_normal((25, 2)).astype(np.float32)
        sr = (yr + 0.3 * rng.standard_normal((25, 2))).astype(np.float32)
        y2, p2 = _onehot(rng, 25, 2), _probs(rng, 25, 2)
        ym, pm = _onehot(rng, 25, 4), _probs(rng, 25, 4)
        for (p, j), (y, s) in (((pb, jb), (yb, sb)), ((pr, jr), (yr, sr)),
                               ((proc, jroc), (y2, p2)),
                               ((pbin, jbin), (yb, sb)),
                               ((pmc, jmc), (ym, pm))):
            p.eval(y, s)
            j.eval(y, s)
    assert pb.stats() == jb.stats()
    assert [pb.f1(c) for c in range(3)] == [jb.f1(c) for c in range(3)]
    assert pr.stats() == jr.stats()
    assert [pr.correlation_r2(c) for c in range(2)] == \
        [jr.correlation_r2(c) for c in range(2)]
    assert proc.calculate_auc() == jroc.calculate_auc()
    for a, b in zip(proc.get_roc_curve(), jroc.get_roc_curve()):
        np.testing.assert_array_equal(a, b)
    assert pbin.average_auc() == jbin.average_auc()
    assert [pmc.calculate_auc(c) for c in range(4)] == \
        [jmc.calculate_auc(c) for c in range(4)]


# ------------------------------------------------------- the runtimes
def _lenet_pair():
    jnet = JaxNet(jax_zoo.LeNet().conf()).init()
    pnet = MultiLayerNetwork(zoo.LeNet().conf(), device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    return jnet, pnet


def _graph_pair(n_out=4):
    g = (NeuralNetConfiguration.builder().seed(3).graph_builder()
         .add_inputs("in").set_input_types(InputType.feed_forward(6)))
    g.add_layer("h", DenseLayer(n_out=8, activation="tanh"), "in")
    g.add_layer("out", OutputLayer(n_out=n_out, activation="softmax"), "h")
    g.set_outputs("out")
    conf = g.build()
    jnet = JaxGraph(JaxGraphConf.from_json(conf.to_json())).init()
    pnet = ComputationGraph(conf, device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    state_from_numpy(pnet, _np(jnet.state_tree))
    return jnet, pnet


def _batches(rng, n, shape, k, bs=32):
    x = rng.random((n,) + shape, dtype=np.float32)
    return x, _onehot(rng, n, k), bs


def _iters(x, y, bs, **kw):
    return (ArrayDataSetIterator(x, y, bs, **kw),
            JaxArrayIterator(x, y, bs, **kw))


@pytest.mark.parametrize("kind", ["lenet", "graph"])
def test_evaluate_matches_jax(kind):
    rng = np.random.default_rng(4)
    if kind == "lenet":
        (jnet, pnet), (x, y, bs) = _lenet_pair(), _batches(rng, 96, (784,),
                                                           10)
    else:
        (jnet, pnet), (x, y, bs) = _graph_pair(), _batches(rng, 80, (6,), 4,
                                                           bs=24)
    pe, je = pnet.evaluate(_iters(x, y, bs)[0]), jnet.evaluate(
        _iters(x, y, bs)[1])
    np.testing.assert_array_equal(pe.confusion.matrix, je.confusion.matrix)
    assert pe.stats() == je.stats()
    np.testing.assert_array_equal(pnet.predict(x), np.asarray(jnet.predict(x)))
    pr = pnet.evaluate_roc_multi_class(_iters(x, y, bs)[0])
    jr = jnet.evaluate_roc_multi_class(_iters(x, y, bs)[1])
    k = y.shape[1]
    np.testing.assert_allclose([pr.calculate_auc(c) for c in range(k)],
                               [jr.calculate_auc(c) for c in range(k)],
                               **FIG_TOL)
    preg = pnet.evaluate_regression(_iters(x, y, bs)[0])
    jreg = jnet.evaluate_regression(_iters(x, y, bs)[1])
    np.testing.assert_allclose(
        [preg.mean_squared_error(c) for c in range(k)],
        [jreg.mean_squared_error(c) for c in range(k)], **FIG_TOL)


def test_graph_binary_roc_matches_jax():
    rng = np.random.default_rng(5)
    jnet, pnet = _graph_pair(n_out=2)
    x, y, bs = _batches(rng, 60, (6,), 2, bs=16)
    pr = pnet.evaluate_roc(_iters(x, y, bs)[0], threshold_steps=10)
    jr = jnet.evaluate_roc(_iters(x, y, bs)[1], threshold_steps=10)
    np.testing.assert_allclose(pr.calculate_auc(), jr.calculate_auc(),
                               **FIG_TOL)
    for a, b in zip(pr.get_roc_curve(), jr.get_roc_curve()):
        np.testing.assert_allclose(a, b, **FIG_TOL)


def test_evaluate_moves_only_indices_for_plain_labels(monkeypatch):
    rng = np.random.default_rng(6)
    _, pnet = _lenet_pair()
    x, y, bs = _batches(rng, 50, (784,), 10, bs=16)

    def no_output(*a, **k):
        raise AssertionError("the output to the host on the plain-label "
                             "path")

    want = pnet.evaluate(ArrayDataSetIterator(x, y, bs)).confusion.matrix
    monkeypatch.setattr(pnet, "_output_host", no_output)
    got = pnet.evaluate(ArrayDataSetIterator(x, y, bs))
    np.testing.assert_array_equal(got.confusion.matrix, want)
    assert got.confusion.matrix.sum() == 50
    # a labels mask takes the full output, as in JAX
    mask = (np.arange(50) % 3 != 0).astype(np.float32)
    with pytest.raises(AssertionError, match="plain-label path"):
        pnet.evaluate(ArrayDataSetIterator(x, y, bs, labels_mask=mask))


def test_masked_labels_match_jax():
    rng = np.random.default_rng(7)
    jnet, pnet = _lenet_pair()
    x, y, bs = _batches(rng, 48, (784,), 10, bs=16)
    mask = (np.arange(48) % 4 != 0).astype(np.float32)
    pit, jit = _iters(x, y, bs, labels_mask=mask)
    pe, je = pnet.evaluate(pit), jnet.evaluate(jit)
    np.testing.assert_array_equal(pe.confusion.matrix, je.confusion.matrix)
    assert pe.confusion.matrix.sum() == 36


def test_graph_evaluate_outputs_by_name():
    rng = np.random.default_rng(8)
    jnet, pnet = _graph_pair()
    x, y, bs = _batches(rng, 40, (6,), 4, bs=20)
    pe = pnet.evaluate_outputs(_iters(x, y, bs)[0])
    je = jnet.evaluate_outputs(_iters(x, y, bs)[1])
    assert list(pe) == list(je) == ["out"]
    np.testing.assert_array_equal(pe["out"].confusion.matrix,
                                  je["out"].confusion.matrix)
    np.testing.assert_array_equal(
        pnet.evaluate(_iters(x, y, bs)[0], output_name="out")
        .confusion.matrix, je["out"].confusion.matrix)
    with pytest.raises(ValueError, match="Unknown output"):
        pnet.evaluate(_iters(x, y, bs)[0], output_name="nope")
