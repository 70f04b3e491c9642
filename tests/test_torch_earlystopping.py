"""Early stopping, its savers and listeners, and the gradient check in the
port against the JAX package, on the CPU.

`EarlyStoppingTrainer` on the same data and JAX's weights carried
across gives JAX's termination reason, best epoch and `score_vs_epoch`
under MaxEpochs, ScoreImprovement and InvalidScore; the best model of
`InMemoryModelSaver` and `LocalFileModelSaver` (whose zip loads in JAX)
gives the best epoch's outputs; `EvaluativeListener` reports JAX's
accuracy each epoch; `check_gradients` passes the JAX package's own
gradient-check cases (softmax/mcxent, identity/mse, l1 and l2), a small
LeNet and a ComputationGraph in float64, and fails a planted wrong
gradient; `CheckpointManager` and `EarlyStoppingParallelTrainer` refuse
naming A6.

Tolerances: held-out scores within 1e-5 relative (float32 losses summed
in another order, as `test_torch_training.py`); outputs within 1e-5
absolute; the gradient check's own 1e-3 relative error in float64."""

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.data.iterators import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.gradientcheck import (
    check_gradients as jax_check_gradients,
)
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.models import serialize as jser
from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JaxConf
from deeplearning4j_tpu.optim.listeners import (
    EvaluativeListener as JaxEvaluative,
)
from deeplearning4j_tpu_torch import earlystopping as pes
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
from deeplearning4j_tpu_torch.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.models.serialize import CheckpointManager
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization, DenseLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.optim.listeners import (
    EvaluativeListener, TimeIterationListener,
)
from deeplearning4j_tpu_torch.optim.updaters import Sgd
from deeplearning4j_tpu_torch.zoo import LeNet

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
OUT_TOL = dict(rtol=0, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _toy(n, d=8, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d, classes))
    y = (x @ w + 0.5 * rng.standard_normal((n, classes))).argmax(-1)
    return x, np.eye(classes, dtype=np.float32)[y]


def _mlp_conf(lr=0.1, d=8, classes=3, **kw):
    b = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(lr))
         .activation("tanh"))
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return (b.list(DenseLayer(n_out=16),
                   OutputLayer(n_out=classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(d)).build())


def _pair(conf):
    jnet = JaxNet(JaxConf.from_json(conf.to_json())).init()
    pnet = MultiLayerNetwork(conf, device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    return jnet, pnet


def _run_both(conditions, *, train=None, lr=0.1, saver=None):
    """The same trainer in both packages; `conditions(side)` gives
    (epoch conditions, iteration conditions) from `jes` or `pes`."""
    x, y = train if train is not None else _toy(64)
    xv, yv = _toy(32, seed=1)
    jnet, pnet = _pair(_mlp_conf(lr))
    out = []
    for side, net, it in ((jes, jnet, JaxArrayIterator),
                          (pes, pnet, ArrayDataSetIterator)):
        epoch_c, iter_c = conditions(side)
        cfg = side.EarlyStoppingConfiguration(
            score_calculator=side.DataSetLossCalculator(it(xv, yv, 16)),
            epoch_termination_conditions=epoch_c,
            iteration_termination_conditions=iter_c)
        if saver is not None and side is pes:
            cfg.model_saver = saver
        out.append(side.EarlyStoppingTrainer(cfg, net, it(x, y, 16)).fit())
    return out, (jnet, pnet), (xv, yv)


def _same_result(jr, pr):
    assert pr.termination_reason == jr.termination_reason
    assert pr.termination_details == jr.termination_details
    assert (pr.total_epochs, pr.best_model_epoch) == \
        (jr.total_epochs, jr.best_model_epoch)
    assert list(pr.score_vs_epoch) == list(jr.score_vs_epoch)
    np.testing.assert_allclose(list(pr.score_vs_epoch.values()),
                               list(jr.score_vs_epoch.values()), **SCORE_TOL)
    np.testing.assert_allclose(pr.best_model_score, jr.best_model_score,
                               **SCORE_TOL)


def test_max_epochs_matches_jax():
    (jr, pr), (jnet, pnet), (xv, _) = _run_both(
        lambda s: ([s.MaxEpochsTerminationCondition(4)], []))
    _same_result(jr, pr)
    assert pr.termination_reason == "EpochTermination"
    assert pr.total_epochs == 4 and pnet.iteration == jnet.iteration == 16
    np.testing.assert_allclose(pr.best_model.output(xv).numpy(),
                               np.asarray(jr.best_model.output(xv)),
                               **OUT_TOL)


def test_score_improvement_matches_jax():
    """A minimum improvement no epoch reaches: the condition counts
    every epoch after the first as no improvement, and patience 1 stops
    the run two epochs later; the trainer still keeps the lowest
    score's model."""
    (jr, pr), _, _ = _run_both(lambda s: (
        [s.ScoreImprovementEpochTerminationCondition(1, 1e9),
         s.MaxEpochsTerminationCondition(10)], []))
    _same_result(jr, pr)
    assert "ScoreImprovement" in pr.termination_details
    scores = pr.score_vs_epoch
    assert pr.total_epochs == 3
    assert pr.best_model_epoch == min(scores, key=scores.get)


def test_invalid_score_matches_jax():
    """A NaN in the second batch: the step's loss is NaN in both."""
    x, y = _toy(64)
    x[20, 3] = np.nan
    (jr, pr), (jnet, pnet), _ = _run_both(lambda s: (
        [s.MaxEpochsTerminationCondition(5)],
        [s.InvalidScoreIterationTerminationCondition()]), train=(x, y))
    _same_result(jr, pr)
    assert pr.termination_reason == "IterationTermination"
    assert pr.termination_details == \
        "InvalidScoreIterationTerminationCondition at iteration 2"
    assert pnet.iteration == jnet.iteration == 2


def test_local_file_saver_zip_loads_in_jax(tmp_path):
    saver = pes.LocalFileModelSaver(str(tmp_path))
    (jr, pr), _, (xv, _) = _run_both(
        lambda s: ([s.MaxEpochsTerminationCondition(3)], []), saver=saver)
    _same_result(jr, pr)
    best = jser.load_model(tmp_path / "bestModel.zip")
    assert isinstance(pr.best_model, MultiLayerNetwork)
    np.testing.assert_allclose(np.asarray(best.output(xv)),
                               pr.best_model.output(xv).numpy(), **OUT_TOL)
    np.testing.assert_allclose(np.asarray(jr.best_model.output(xv)),
                               pr.best_model.output(xv).numpy(), **OUT_TOL)


def test_evaluative_listener_reports_jax_accuracy():
    x, y = _toy(64)
    xv, yv = _toy(48, seed=2)
    jnet, pnet = _pair(_mlp_conf(0.2))
    jl = JaxEvaluative(JaxArrayIterator(xv, yv, 16))
    pl = EvaluativeListener(ArrayDataSetIterator(xv, yv, 16))
    jnet.listeners.append(jl)
    pnet.listeners += [pl, TimeIterationListener(8, frequency=2)]
    jnet.fit(x, y, batch_size=16, epochs=3)
    pnet.fit(x, y, batch_size=16, epochs=3)
    assert len(pl.evaluations) == 3
    assert [e.accuracy() for e in pl.evaluations] == \
        [e.accuracy() for e in jl.evaluations]
    for p, j in zip(pl.evaluations, jl.evaluations):
        np.testing.assert_array_equal(p.confusion.matrix, j.confusion.matrix)


# -------------------------------------------------------- gradient checks
def _check_cases():
    """The JAX package's `TestGradientChecks` cases
    (`tests/test_core_slice.py`), built by the port's builder."""
    def mlp(act, out_act, loss, n_out, **kw):
        b = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1))
             .activation(act))
        for k, v in kw.items():
            b = getattr(b, k)(v)
        return (b.list(DenseLayer(n_out=5 if loss == "mcxent" else 6),
                       OutputLayer(n_out=n_out, activation=out_act,
                                   loss=loss))
                .set_input_type(InputType.feed_forward(4)).build())

    rng = np.random.default_rng(3)
    xr = rng.standard_normal((8, 4))
    yr = rng.standard_normal((8, 2))
    return {
        "mcxent": (mlp("tanh", "softmax", "mcxent", 3),
                   _toy(8, d=4, seed=1)),
        "mse_identity": (mlp("sigmoid", "identity", "mse", 2), (xr, yr)),
        "l1_l2": (mlp("tanh", "softmax", "mcxent", 3, l1=1e-2, l2=1e-2),
                  _toy(8, d=4, seed=2)),
    }


@pytest.mark.parametrize("case", ["mcxent", "mse_identity", "l1_l2"])
def test_gradient_check_cases_pass_as_in_jax(case):
    conf, (x, y) = _check_cases()[case]
    jnet, pnet = _pair(conf)
    assert check_gradients(pnet, x, y)
    assert jax_check_gradients(jnet, x, y)     # x64: tests/conftest.py


def test_gradient_check_passes_a_small_lenet_in_float64():
    """The zoo LeNet at 16x16x1 and 3 classes (52,573 parameters; 300 of
    them checked)."""
    net = LeNet(input_shape=(16, 16, 1), num_classes=3).init(device="cpu")
    rng = np.random.default_rng(4)
    x = rng.random((4, 256))
    y = np.eye(3)[rng.integers(0, 3, 4)]
    assert net.num_params() == 52_573
    assert check_gradients(net, x, y, subset=300, seed=1)


def test_gradient_check_passes_a_graph_with_batch_norm():
    g = (NeuralNetConfiguration.builder().seed(2).graph_builder()
         .add_inputs("in").set_input_types(InputType.feed_forward(4)))
    g.add_layer("h", DenseLayer(n_out=5, activation="tanh"), "in")
    g.add_layer("bn", BatchNormalization(), "h")
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax"), "bn")
    g.set_outputs("out")
    net = ComputationGraph(g.build(), device="cpu").init()
    x, y = _toy(6, d=4, seed=5)
    assert check_gradients(net, x, y)


def test_gradient_check_fails_a_planted_wrong_gradient(monkeypatch):
    """The loss's value unchanged, its gradient 1.5 times too large."""
    conf, (x, y) = _check_cases()["mcxent"]
    net = MultiLayerNetwork(conf, device="cpu").init()
    right = net._loss

    def wrong(*a, **k):
        loss, st = right(*a, **k)
        return 1.5 * loss - 0.5 * loss.detach(), st

    monkeypatch.setattr(net, "_loss", wrong)
    assert not check_gradients(net, x, y)


def test_gradient_check_refuses_a_net_on_the_card():
    net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    net.device = type(net.device)("cuda", 0)
    with pytest.raises(ValueError, match="on the CPU"):
        check_gradients(net, *_toy(4))


def test_checkpoint_manager_and_parallel_trainer_refuse_naming_a6(tmp_path):
    """Both refused naming A6 until slice 30. Now `CheckpointManager`
    round-trips a net and the parallel trainer, on a one-rank mesh,
    trains as the plain trainer does (their 2-rank and JAX cases are in
    `test_torch_recovery.py` and `test_torch_parallel.py`)."""
    import torch

    net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, net)
    mgr.wait()
    other = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    other.params_tree["layer0_denselayer"]["W"].add_(1.0)
    mgr.restore(other)
    assert torch.equal(other.params_tree["layer0_denselayer"]["W"],
                       net.params_tree["layer0_denselayer"]["W"])
    cfg = lambda: pes.EarlyStoppingConfiguration(
        epoch_termination_conditions=[pes.MaxEpochsTerminationCondition(2)])
    plain = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    try:
        got = pes.EarlyStoppingParallelTrainer(
            cfg(), net, ArrayDataSetIterator(*_toy(8))).fit()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    want = pes.EarlyStoppingTrainer(
        cfg(), plain, ArrayDataSetIterator(*_toy(8))).fit()
    assert (got.termination_reason, got.total_epochs) == \
        (want.termination_reason, want.total_epochs)
    for name, sub in plain.params_tree.items():
        for k, v in sub.items():
            assert torch.equal(net.params_tree[name][k], v), (name, k)
