"""The port's recovery path (A6, first part): `ShardedCheckpointer`'s
COMMIT protocol, fault hook, rotation and error latch; exact mid-epoch
resume of a `MultiLayerNetwork` stopped by a real SIGTERM and of a
`ComputationGraph` stopped by `stop_fn`, and a fused partial window —
each bit-identical to the uninterrupted run on the CPU; a 2-rank
`ElasticTrainer` checkpoint (one module-scoped gloo group,
`torch_parallel_ranks.py`) restored onto one rank; a JAX checkpoint
taken on a 2-device mesh with sharded moments restored into the port,
whose next steps match JAX's continued run; the chaos injectors and
`CheckpointManager`.

Tolerances: resumes within one package are compared bit for bit. The
2→1 restore and the JAX checkpoint cross a change of summation order
(2 ranks → 1, XLA → torch), so their float32 losses and parameters
agree within 2e-5 of the largest |reference value| (1.0 at least).
"""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import InputType as JaxInputType
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import (
    BatchNormalization as JaxBN, DenseLayer as JaxDense,
    OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.optim.listeners import (
    TrainingListener as JaxListener,
)
from deeplearning4j_tpu.optim.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxPW
from deeplearning4j_tpu.parallel import (
    ShardedCheckpointer as JaxCheckpointer,
)
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.models.serialize import CheckpointManager
from deeplearning4j_tpu_torch.nn.config import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.observe import commsmon
from deeplearning4j_tpu_torch.observe.flight import (
    FlightRecorder, get_flight, set_flight,
)
from deeplearning4j_tpu_torch.optim.listeners import TrainingListener
from deeplearning4j_tpu_torch.optim.updaters import Adam
from deeplearning4j_tpu_torch.parallel import (
    CheckpointIOFault, ElasticTrainer, FailingIterator, InjectedFault,
    ParallelWrapper, PreemptionHandler, ShardedCheckpointer, SigtermAtStep,
    StallingIterator,
)
from torch_parallel_ranks import document, launch, results

WORLD = 2
TOL = 2e-5


def _net(seed=7):
    return MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
        .list(DenseLayer(n_out=16, activation="relu"),
              OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.feed_forward(12)).build(),
        device="cpu").init()


def _graph(seed=7):
    return ComputationGraph(
        NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
        .graph_builder().add_inputs("in")
        .add_layer("dense", DenseLayer(n_out=16, activation="relu"), "in")
        .add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                      loss="mcxent"), "dense")
        .set_outputs("out")
        .set_input_types(InputType.feed_forward(12)).build(),
        device="cpu").init()


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    yi = rng.integers(0, 4, n)
    x[np.arange(n), yi % 12] += 2.0
    return x, np.eye(4, dtype=np.float32)[yi]


def _batches(x, y, bs=16):
    return [DataSet(x[i:i + bs], y[i:i + bs]) for i in range(0, len(x), bs)]


class _Rec(TrainingListener):
    """Every step's device loss (read after the fit)."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, net, it, ep, loss):
        self.losses.append(loss)


def _curve(losses):
    return np.asarray([float(v) for v in losses])


def _params(net):
    return {f"{l}/{k}": v.detach().numpy().copy()
            for l, sub in net.params_tree.items() for k, v in sub.items()}


def _close(got, want, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


@pytest.fixture
def one_rank():
    """A one-rank process group for the tests that wrap a net (the
    wrapper's mesh); destroyed after the test."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


# ------------------------------------------------------ bit-identical resume
def test_mln_real_sigterm_mid_epoch(tmp_path):
    x, y = _data()
    ref_net, ref = _net(), _Rec()
    ref_net.listeners.append(ref)
    ref_net.fit(x, y, epochs=2, batch_size=16)        # 4 batches an epoch

    prev = signal.getsignal(signal.SIGTERM)
    net_b, rec_b = _net(), _Rec()
    sig = SigtermAtStep(3)
    net_b.listeners += [rec_b, sig]
    ck = ShardedCheckpointer(str(tmp_path / "ck"))
    net_b.fit(x, y, epochs=2, batch_size=16, checkpointer=ck,
              preemption=True)
    assert sig.fired and net_b.stopped_early and len(rec_b.losses) == 3
    assert ck.latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) is prev   # handler restored

    net_c, rec_c = _net(seed=99), _Rec()              # init overwritten
    net_c.listeners.append(rec_c)
    net_c.fit(x, y, epochs=2, batch_size=16,
              checkpointer=ShardedCheckpointer(str(tmp_path / "ck")),
              resume="auto")
    assert len(rec_c.losses) == 5
    np.testing.assert_array_equal(
        np.concatenate([_curve(rec_b.losses), _curve(rec_c.losses)]),
        _curve(ref.losses))
    for k, v in _params(ref_net).items():
        np.testing.assert_array_equal(_params(net_c)[k], v, k)


def test_cg_stop_fn_mid_epoch(tmp_path):
    x, y = _data()
    ref_net, ref = _graph(), _Rec()
    ref_net.listeners.append(ref)
    ref_net.fit(x, y, epochs=2, batch_size=16)

    net_b, rec_b = _graph(), _Rec()
    net_b.listeners.append(rec_b)
    ck = ShardedCheckpointer(str(tmp_path / "ck"))
    net_b.fit(x, y, epochs=2, batch_size=16, checkpointer=ck,
              stop_fn=lambda: len(rec_b.losses) >= 5)
    assert net_b.stopped_early and len(rec_b.losses) == 5

    net_c, rec_c = _graph(seed=99), _Rec()
    net_c.listeners.append(rec_c)
    net_c.fit(x, y, epochs=2, batch_size=16,
              checkpointer=ShardedCheckpointer(str(tmp_path / "ck")),
              resume="auto")
    assert len(rec_c.losses) == 3
    np.testing.assert_array_equal(
        np.concatenate([_curve(rec_b.losses), _curve(rec_c.losses)]),
        _curve(ref.losses))


def test_fused_partial_window_resume(tmp_path, one_rank):
    """steps_per_dispatch=4 under a one-rank wrapper, the stop landing
    mid-window: the executor drains the partial window per step, the
    checkpoint records the exact cursor, and the resumed run fills its
    windows from there — bit-identical."""
    x, y = _data(n=128)                               # 8 batches an epoch
    net_a, rec_a = _net(), _Rec()
    net_a.listeners.append(rec_a)
    ParallelWrapper(net_a).fit(x, y, epochs=2, batch_size=16,
                               steps_per_dispatch=4)
    assert len(rec_a.losses) == 16

    net_b, rec_b = _net(), _Rec()
    net_b.listeners.append(rec_b)
    wb = ParallelWrapper(net_b)
    ck = ShardedCheckpointer(str(tmp_path / "ck"))
    calls = [0]

    def stop_fn():
        calls[0] += 1
        return calls[0] > 6

    wb.fit(x, y, epochs=2, batch_size=16, steps_per_dispatch=4,
           checkpointer=ck, stop_fn=stop_fn)
    assert wb.stopped_early and len(rec_b.losses) == 6
    assert wb.last_batch_index == 5 and ck.latest_step() == 6

    net_c, rec_c = _net(seed=99), _Rec()
    net_c.listeners.append(rec_c)
    ParallelWrapper(net_c).fit(
        x, y, epochs=2, batch_size=16, steps_per_dispatch=4,
        checkpointer=ShardedCheckpointer(str(tmp_path / "ck")),
        resume="auto")
    assert len(rec_c.losses) == 10
    np.testing.assert_array_equal(
        np.concatenate([_curve(rec_b.losses), _curve(rec_c.losses)]),
        _curve(rec_a.losses))


# ---------------------------------------------------------- COMMIT protocol
def test_half_written_step_invisible_and_latch_drains(tmp_path):
    net = _net()
    ck = ShardedCheckpointer(str(tmp_path / "ck"), async_save=True)
    ck.fault_hook = fault = CheckpointIOFault(fail_after=1, kind="shard",
                                              times=1)
    ck.save(net, step=1)            # dies after one shard file
    ck.save(net, step=2)            # the fault's budget is spent: commits
    with pytest.raises(InjectedFault):
        ck.wait()
    ck.wait()                       # the latch drained
    assert fault.raised == 1 and ck.steps() == [2]
    half = tmp_path / "ck" / "step-0000000001" / "process-0"
    assert half.is_dir() and not (half / "COMMIT").exists()
    with pytest.raises(FileNotFoundError):
        ck._read_step(1)


def test_resume_picks_previous_committed_step(tmp_path):
    """The writer dies in the LAST checkpoint: `wait()` surfaces it at
    the fit's end, resume takes the previous committed step and retrains
    the lost batch bit-identically."""
    x, y = _data()
    ref_net, ref = _net(), _Rec()
    ref_net.listeners.append(ref)
    ref_net.fit(x, y, epochs=1, batch_size=16)

    net_b, rec_b = _net(), _Rec()
    net_b.listeners.append(rec_b)
    ck = ShardedCheckpointer(str(tmp_path / "ck"))
    inner = CheckpointIOFault(fail_after=1, kind="shard", times=1)
    ck.fault_hook = lambda kind, path: (
        inner(kind, path) if f"step-{4:010d}" in path else None)
    with pytest.raises(InjectedFault):
        net_b.fit(x, y, epochs=1, batch_size=16, checkpointer=ck)
    assert len(rec_b.losses) == 4 and ck.steps() == [1, 2, 3]

    net_c, rec_c = _net(seed=99), _Rec()
    net_c.listeners.append(rec_c)
    net_c.fit(x, y, epochs=1, batch_size=16,
              checkpointer=ShardedCheckpointer(str(tmp_path / "ck")),
              resume="auto")
    assert len(rec_c.losses) == 1
    np.testing.assert_array_equal(
        np.concatenate([_curve(rec_b.losses[:3]), _curve(rec_c.losses)]),
        _curve(ref.losses))


def test_rotation_never_deletes_pinned_step_and_skips_strays(tmp_path):
    net = _net()
    ck = ShardedCheckpointer(str(tmp_path / "ck"), max_to_keep=1,
                             async_save=False)
    ck.save(net, step=1)
    with ck._state_lock:            # a restore holds step 1 open
        ck._pinned.add(1)
    ck.save(net, step=2)
    ck.save(net, step=3)
    assert ck.steps() == [1, 3]
    ck._read_step(1)
    with ck._state_lock:
        ck._pinned.discard(1)
    ck.save(net, step=4)
    assert ck.steps() == [4]
    (tmp_path / "ck" / "step-stray").write_text("not a dir")
    os.makedirs(tmp_path / "ck" / "step-0000000099")      # no COMMIT
    assert ck.latest_step() == 4
    with pytest.raises(FileNotFoundError):
        ShardedCheckpointer(str(tmp_path / "empty")).restore_into(net)


def test_wait_error_latch_surfaces_once(tmp_path):
    net = _net()
    ck = ShardedCheckpointer(str(tmp_path / "ck"), async_save=True)
    ck.fault_hook = CheckpointIOFault(fail_after=0, kind="manifest", times=1)
    ck.save(net, step=1)
    with pytest.raises(InjectedFault):
        ck.wait()
    ck.wait()
    ck.save(net, step=2)
    ck.wait()
    assert ck.latest_step() == 2


# ------------------------------------------------- input-pipeline faults
def test_iterator_crash_dumps_flight_and_resume_breadcrumbs(tmp_path):
    prev = set_flight(FlightRecorder(dump_dir=str(tmp_path)))
    try:
        x, y = _data()
        batches = _batches(x, y)
        ref_net, ref = _net(), _Rec()
        ref_net.listeners.append(ref)
        ref_net.fit(batches, epochs=1)

        net_b, rec_b = _net(), _Rec()
        net_b.listeners.append(rec_b)
        ck = ShardedCheckpointer(str(tmp_path / "ck"))
        with pytest.raises(InjectedFault):
            net_b.fit(FailingIterator(batches, fail_at=2), epochs=1,
                      checkpointer=ck)
        assert len(rec_b.losses) == 2
        dumps = [n for n in os.listdir(tmp_path)
                 if n.startswith("flight_") and n.endswith(".json")]
        assert len(dumps) == 1 and "training_exception" in dumps[0]

        net_c, rec_c = _net(seed=99), _Rec()
        net_c.listeners.append(rec_c)
        net_c.fit(batches, epochs=1,
                  checkpointer=ShardedCheckpointer(str(tmp_path / "ck")),
                  resume="auto")
        np.testing.assert_array_equal(
            np.concatenate([_curve(rec_b.losses), _curve(rec_c.losses)]),
            _curve(ref.losses))
        resumes = [e for e in get_flight().events() if e["kind"] == "resume"]
        assert resumes[-1]["data"]["prior_dump"] == \
            os.path.join(str(tmp_path), dumps[0])
    finally:
        set_flight(prev)


def test_stalling_iterator_is_ordinary_etl_time():
    x, y = _data()
    batches = _batches(x, y)
    ref_net, ref = _net(), _Rec()
    ref_net.listeners.append(ref)
    ref_net.fit(batches, epochs=1)
    net, rec = _net(), _Rec()
    net.listeners.append(rec)
    it = StallingIterator(batches, stall_at=1, stall_s=0.05)
    net.fit(it, epochs=1, stop_fn=lambda: False)
    assert it.stalled == 1 and not net.stopped_early
    np.testing.assert_array_equal(_curve(rec.losses), _curve(ref.losses))


# ------------------------------------------------------ preemption handler
def test_preemption_handler_restores_and_degrades_off_main_thread():
    h = PreemptionHandler(signals=(signal.SIGUSR2,))
    prev = signal.getsignal(signal.SIGUSR2)
    with h:
        os.kill(os.getpid(), signal.SIGUSR2)
        assert h.preempted
    assert signal.getsignal(signal.SIGUSR2) is prev
    res = {}

    def worker():
        handler = PreemptionHandler().install()
        x, y = _data()
        net, rec = _net(), _Rec()
        sig = SigtermAtStep(2, handler=handler)
        net.listeners += [rec, sig]
        net.fit(x, y, epochs=2, batch_size=16, preemption=handler)
        handler.uninstall()
        res.update(degraded=handler.degraded, fired=sig.fired,
                   stopped=net.stopped_early, losses=len(rec.losses))

    t = threading.Thread(target=worker)
    t.start()
    t.join(60)
    assert res == {"degraded": True, "fired": True, "stopped": True,
                   "losses": 2}


def test_resume_auto_without_checkpointer_raises():
    x, y = _data(n=16)
    with pytest.raises(ValueError, match="nothing to restore"):
        _net().fit(x, y, epochs=1, batch_size=16, resume="auto")


# ------------------------------------------------------ CheckpointManager
def test_checkpoint_manager_round_trip_and_rotation(tmp_path):
    x, y = _data()
    net = _net()
    net.fit(x, y, epochs=1, batch_size=16)
    mgr = CheckpointManager(tmp_path / "mgr", max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, net)
    mgr.wait()
    other = _net(seed=5)
    assert mgr.restore(other) is other
    assert (other.iteration, other.epoch) == (net.iteration, net.epoch)
    for k, v in _params(net).items():
        np.testing.assert_array_equal(_params(other)[k], v, k)
    for a, b in zip(
            [t for s in net.updater_state.values() for d in s.values()
             for t in d.values()],
            [t for s in other.updater_state.values() for d in s.values()
             for t in d.values()]):
        assert torch.equal(a, b)
    assert sorted(os.listdir(tmp_path / "mgr")) == \
        ["step-0000000002", "step-0000000003"]
    mgr.close()


# --------------------------------------------------------- 2 ranks → 1
def _bn_conf():
    return (JaxNNC.builder().seed(13).updater(JaxNesterovs(0.05, 0.9))
            .activation("tanh")
            .list(JaxDense(n_out=16), JaxBN(),
                  JaxOutput(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(8)).build())


def _bn_data(n=48):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    return x, np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_net(conf, jparams):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    return params_from_numpy(net, jparams)


@pytest.fixture(scope="module")
def elastic_ranks(tmp_path_factory):
    """Two 2-rank ElasticTrainer fits on one gloo group: one
    uninterrupted, one stopped after iteration 3 (checkpoints every 2,
    the stop position written by the final snapshot)."""
    d = tmp_path_factory.mktemp("recovery")
    conf = _bn_conf()
    jparams = _np_tree(JaxNet(conf).init().params_tree)
    x, y = _bn_data()
    inputs = {"x": x, "y": y}
    for layer, sub in jparams.items():
        for k, v in sub.items():
            inputs[f"w/{layer}/{k}"] = v
    np.savez(d / "inputs.npz", **inputs)
    base = {"kind": "elastic", "conf": conf.to_json(), "weights": "w",
            "x": "x", "y": "y", "epochs": 1, "batch": 8, "every": 2}
    cases = [dict(base, name="ref", ckpt=str(d / "ck_ref")),
             dict(base, name="stop", ckpt=str(d / "ck"), stop_at=3)]
    (d / "cases.json").write_text(json.dumps({"recovery": cases}))
    launch("recovery", WORLD, str(d))
    return str(d), conf, jparams


def test_elastic_two_rank_checkpoint_restores_onto_one_rank(
        elastic_ranks, one_rank, monkeypatch):
    """The 2-rank ElasticTrainer stopped at iteration 3 is resumable;
    its checkpoint (each rank's half of every Nesterov moment) restores
    into a one-rank ElasticTrainer, which finishes the epoch on the
    2-rank run's losses and parameters; the witness records the
    reshard."""
    d, conf, jparams = elastic_ranks
    stop = document(d, "stop", 0)
    assert stop == {"completed": False, "preempted": True,
                    "resumable": True, "iteration": 3}
    assert document(d, "ref", 0)["completed"]
    ref = results(d, "ref", WORLD)[0]
    monkeypatch.setenv("DL4J_TPU_COMMSMON", "1")
    commsmon.reset_reshard_witness()
    wit = commsmon.get_reshard_witness()
    try:
        net = _port_net(conf, jparams)
        losses = _Rec()
        net.listeners.append(losses)
        trainer = ElasticTrainer(net, os.path.join(d, "ck"),
                                 checkpoint_every=2)
        x, y = _bn_data()
        res = trainer.fit(x, y, epochs=1, batch_size=8)
        assert res["completed"] and res["iteration"] == 6
        _close(_curve(losses.losses), ref["losses"][3:], "losses")
        for k, v in _params(net).items():
            _close(v, ref[f"params/{k}"], k)
        restores = [e for e in wit.report()["reshards"]
                    if e["what"] == "restore"]
        assert restores and restores[0]["from_ranks"] == 2 and \
            restores[0]["to_ranks"] == 1
    finally:
        commsmon.reset_reshard_witness()


# ------------------------------------------------- a JAX checkpoint → port
class _JaxRec(JaxListener):
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, epoch, score):
        self.losses.append(float(score))


def test_jax_checkpoint_from_a_two_device_mesh_continues_in_the_port(
        tmp_path, devices8):
    """JAX's wrapper on a 2-device mesh (Nesterovs moments split across
    the replicas, batch norm) checkpoints at iteration 4 of 6; the port
    restores that step into a plain net (params, updater state, running
    statistics, iteration, epoch, position) and its next two steps match
    JAX's uninterrupted run. JAX's PRNG key is not carried over: the
    flight recorder says so."""
    conf = _bn_conf()
    jnet = JaxNet(conf).init()
    jparams = _np_tree(jnet.params_tree)
    x, y = _bn_data()
    rec = _JaxRec()
    jnet.listeners.append(rec)
    ck = JaxCheckpointer(str(tmp_path / "jax"))
    JaxPW(jnet, mesh=jax_mesh({"data": 2}, devices=devices8[:2]),
          prefetch_buffer=0).fit(x, y, epochs=1, batch_size=8,
                                 checkpointer=ck, checkpoint_every=4)
    ck.wait()
    assert 4 in ck.steps()
    manifest = json.loads((tmp_path / "jax" / "step-0000000004" /
                           "process-0" / "manifest.json").read_text())
    split = [k for k, v in manifest["leaves"].items()
             if k.startswith("updater:") and len(v["shards"]) == 2]
    assert split                                # replica-sharded moments

    net = _port_net(conf, jparams)
    ours = ShardedCheckpointer(str(tmp_path / "jax"))
    prev = set_flight(FlightRecorder(dump_dir=str(tmp_path)))
    try:
        pos = ours.restore_into(net, step=4)
        assert pos == {"batch_in_epoch": 4}
        assert (net.iteration, net.epoch) == (4, 0)
        assert any(e["kind"] == "rng_not_restored"
                   for e in get_flight().events())
    finally:
        set_flight(prev)
    losses = _Rec()
    net.listeners.append(losses)
    net.fit(x, y, epochs=1, batch_size=8, resume=pos)
    assert net.iteration == 6
    _close(_curve(losses.losses), np.asarray(rec.losses[4:]), "losses")
    for layer, sub in _np_tree(jnet.params_tree).items():
        for k, v in sub.items():
            _close(net.params_tree[layer][k].numpy(), v, f"{layer}/{k}")
    for layer, sub in _np_tree(jnet.state_tree).items():
        for k, v in sub.items():
            _close(net.state_tree[layer][k].numpy(), v, f"{layer}/{k}")
