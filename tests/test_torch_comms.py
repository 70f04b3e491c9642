"""The port's collective observability against the JAX package's (A6,
first part): commsmon's HLO parser, summaries and wire-byte convention
on `tests/test_commsmon.py`'s HLO texts; the runtime ledger after a
2-rank `ParallelWrapper` step (one module-scoped gloo group,
`torch_parallel_ranks.py`) against the count from the parameter tree
under the one-pass ring convention; the watchdog's totals; lockmon's
lock-order inversion and unguarded-field events and donatemon's
use-after-donate events against JAX's on the same scripts. Every
comparison is exact: the parser and the witnesses are text, counts and
bytes."""

import json
import threading

import numpy as np
import pytest

from deeplearning4j_tpu import InputType as JaxInputType
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import (
    BatchNormalization as JaxBN, DenseLayer as JaxDense,
    OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.observe import commsmon as jax_commsmon
from deeplearning4j_tpu.observe import donatemon as jax_donatemon
from deeplearning4j_tpu.observe import lockmon as jax_lockmon
from deeplearning4j_tpu.optim.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu_torch.observe import commsmon, donatemon, lockmon
from deeplearning4j_tpu_torch.observe.watchdog import RecompileWatchdog
from test_commsmon import _FIVE_KINDS
from torch_parallel_ranks import document, launch

WORLD = 2

HLO_TEXTS = {
    "five_kinds": _FIVE_KINDS,
    "iota": ("%ar = f32[64]{0} all-reduce(f32[64]{0} %x), "
             "replica_groups=[2,4]<=[8], to_apply=%add\n"),
    "async": ("%ars = (f32[128]{0}, f32[128]{0}) "
              "all-reduce-start(f32[128]{0} %x), "
              "replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add\n"
              "%ard = f32[128]{0} all-reduce-done("
              "(f32[128]{0}, f32[128]{0}) %ars)\n"),
    "junk": ("HloModule junk\n%a = f32[8]{0} frobnicate(f32[8]{0} %x)\n"
             "not an instruction at all\n"),
    "degenerate": ("%ar = f32[64]{0} all-reduce(f32[64]{0} %x), "
                   "replica_groups={{0}}, to_apply=%add\n"),
    "bf16_gather": ("%ag = bf16[4,512]{1,0} all-gather(bf16[2,512]{1,0} "
                    "%p), replica_groups={{0,1}}, dimensions={0}\n"),
}


# ------------------------------------------------------------ the parser
@pytest.mark.parametrize("name", sorted(HLO_TEXTS))
def test_hlo_parser_and_summary_match_jax(name):
    text = HLO_TEXTS[name]
    ours = commsmon.parse_hlo_collectives(text)
    assert ours == jax_commsmon.parse_hlo_collectives(text)
    assert commsmon.summarize_collectives(ours) == \
        jax_commsmon.summarize_collectives(ours)


def test_wire_bytes_convention_matches_jax():
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "collective-permute", "all-to-all", "broadcast"):
        for payload, g in ((1024, 8), (1024, 4), (1024, 2), (1024, 1),
                           (1024, 0), (7, 3)):
            assert commsmon.wire_bytes(kind, payload, g) == \
                jax_commsmon.wire_bytes(kind, payload, g), (kind, g)


# ------------------------------------------------ the ledger on 2 ranks
def _conf():
    return (JaxNNC.builder().seed(2).updater(JaxNesterovs(0.1, 0.9))
            .activation("tanh")
            .list(JaxDense(n_out=16), JaxBN(),
                  JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(6)).build())


@pytest.fixture(scope="module")
def ledger_ranks(tmp_path_factory):
    """One 2-rank wrapper fit of one step (sharded moments)."""
    d = tmp_path_factory.mktemp("comms")
    conf = _conf()
    jnet = JaxNet(conf).init()
    inputs = {f"w/{l}/{k}": np.asarray(v, np.float32)
              for l, sub in jnet.params_tree.items()
              for k, v in sub.items()}
    rng = np.random.default_rng(1)
    inputs["x"] = rng.standard_normal((8, 6)).astype(np.float32)
    inputs["y"] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    np.savez(d / "inputs.npz", **inputs)
    cases = [{"kind": "ledger", "name": "step", "conf": conf.to_json(),
              "weights": "w", "x": "x", "y": "y", "batch": 8}]
    (d / "cases.json").write_text(json.dumps({"comms": cases}))
    launch("comms", WORLD, str(d))
    shapes = {f"{l}/{k}": np.asarray(v).shape
              for l, sub in jnet.params_tree.items() for k, v in sub.items()}
    return str(d), shapes


def _ring(payload):
    return payload * (WORLD - 1) // WORLD


def test_ledger_counts_one_step_from_the_parameter_tree(ledger_ranks):
    """One step on 2 ranks: one all-reduce of every gradient (4 bytes a
    float32 parameter), one of the loss, one all-gather of every split
    parameter (those with a dim that divides by 2), and
    the batch-norm statistics (Σ and Σ² of the forward, the two sums of
    the backward: 4 x 16 channels x 4 bytes); wire bytes under the ring
    convention, the wrap's broadcast outside the step."""
    d, shapes = ledger_ranks
    param_bytes = 4 * sum(int(np.prod(s)) for s in shapes.values())
    # a leaf with no dim divisible by 2 (the output bias, 3) keeps its
    # whole moment on both ranks and is not gathered
    split_bytes = 4 * sum(int(np.prod(s)) for s in shapes.values()
                          if any(d % WORLD == 0 for d in s))
    for r in range(WORLD):
        doc = document(d, "step", r)
        by = {}
        for op in doc["ops"]:
            if op["purpose"] == "init":
                continue
            row = by.setdefault((op["kind"], op["purpose"]), [0, 0, 0])
            row[0] += 1
            row[1] += op["payload_bytes"]
            row[2] += op["wire_bytes"]
            assert op["group_size"] == WORLD and not op["staged"]
        assert by[("all-reduce", "grads")] == \
            [1, param_bytes, _ring(param_bytes)]
        assert by[("all-reduce", "loss")] == [1, 4, _ring(4)]
        assert by[("all-gather", "params")] == \
            [1, split_bytes, _ring(split_bytes)]
        # batch norm: the forward's Σ and Σ², then their gradients
        assert by[("all-reduce", "bn_stats")] == \
            [4, 4 * 16 * 4, _ring(4 * 16 * 4)]


def test_watchdog_totals_price_the_step(ledger_ranks):
    """The wrapper priced its step into the watchdog: `owner_comm_totals`
    answers with the step's ops and wire bytes (no longer None), and the
    snapshot carries the summary by kind."""
    d, shapes = ledger_ranks
    doc = document(d, "step", 0)
    step_ops = [op for op in doc["ops"] if op["purpose"] != "init"]
    assert doc["owner"] == {
        "programs": 1, "ops": len(step_ops),
        "wire_bytes": sum(op["wire_bytes"] for op in step_ops)}
    assert list(doc["comm_totals"].values()) == [doc["owner"]]
    (summary,) = doc["collectives"].values()
    assert summary == commsmon.summarize_collectives(step_ops)
    assert set(summary["by_kind"]) == {"all-reduce", "all-gather"}


def test_watchdog_record_collectives_matches_jax():
    """The same summary recorded into both packages' watchdogs gives the
    same owner and process totals and the same registry counters."""
    from deeplearning4j_tpu.observe.registry import (
        MetricsRegistry as JaxRegistry,
    )
    from deeplearning4j_tpu.observe.watchdog import (
        RecompileWatchdog as JaxWatchdog,
    )
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry

    summary = commsmon.summarize_collectives(
        commsmon.parse_hlo_collectives(_FIVE_KINDS))
    ours, theirs = RecompileWatchdog(metrics=MetricsRegistry()), \
        JaxWatchdog(metrics=JaxRegistry())
    for wd in (ours, theirs):
        assert wd.owner_comm_totals("PW@1") is None
        wd.record_collectives("PW@1", "ParallelWrapper", ("k", 1), summary)
        wd.record_collectives("PW@1", "ParallelWrapper", ("k", 2), summary)
    assert ours.owner_comm_totals("PW@1") == \
        theirs.owner_comm_totals("PW@1")
    assert ours.comm_totals() == theirs.comm_totals()
    for kind in summary["by_kind"]:
        assert ours._registry().counter(
            "jit_collective_bytes_total", owner="ParallelWrapper",
            kind=kind).value == theirs._registry().counter(
            "jit_collective_bytes_total", owner="ParallelWrapper",
            kind=kind).value


# ------------------------------------------------------ lock witness
def _strip(report):
    return {k: v for k, v in report.items() if k != "static_rules"}


@pytest.mark.parametrize("mod", [lockmon, jax_lockmon],
                         ids=["port", "jax"])
def test_lockmon_disabled_by_default_and_env_flag(monkeypatch, mod):
    monkeypatch.delenv("DL4J_TPU_LOCKMON", raising=False)
    mod.reset_witness()
    assert mod.get_witness() is None
    lk = mod.MonitoredLock("X._lock")
    with lk:
        assert lk.locked()
    monkeypatch.setenv("DL4J_TPU_LOCKMON", "1")
    try:
        w = mod.get_witness()
        assert w is not None and mod.get_witness() is w
    finally:
        mod.reset_witness()


def _lock_script(mod):
    """An unguarded field and a phased ABBA pair on two threads."""
    w = mod.LockWitness()
    store = mod.MonitoredLock("Store._lock", witness=w)
    with store:
        w.witness_field("Store", "items", "Store._lock", write=True)
    w.witness_field("Store", "items", "Store._lock")
    a = mod.MonitoredLock("Pair._a_lock", witness=w)
    b = mod.MonitoredLock("Pair._b_lock", witness=w)
    gate = threading.Event()

    def ab():
        with a:
            with b:
                pass
        gate.set()

    def ba():
        gate.wait(5.0)
        with b:
            with a:
                pass

    ts = [threading.Thread(target=ab, name="ab"),
          threading.Thread(target=ba, name="ba")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10.0)
    rep = w.report()
    for ev in rep["unguarded"]:
        ev.pop("site")
    for inv in rep["inversions"]:
        inv["order_a"].pop("site")
        inv["order_b"].pop("site")
    return rep


def test_lockmon_inversion_and_unguarded_field_match_jax():
    ours, theirs = _lock_script(lockmon), _lock_script(jax_lockmon)
    assert _strip(ours) == _strip(theirs)
    assert ours["inversions"][0]["rule"] == "GL702"
    assert ours["unguarded"][0]["rule"] == "GL701"
    assert ours["static_rules"] == theirs["static_rules"]


# -------------------------------------------------- donation witness
def _donate_script(mod):
    w = mod.DonationWitness()
    state = {"w": np.zeros((2, 2), np.float32),
             "b": np.zeros((2,), np.float32)}
    marked = [w.mark_donated(state, "state", "train_step"),
              w.mark_donated({"k": 3}, "k", "train_step")]
    first = w.touch(state, "state")
    again = w.touch(state, "state")

    def step(state, batch):
        return {k: v + batch for k, v in state.items()}

    inst = mod.instrument(step, (0,), name="make_step.step",
                          arg_names=("state", "batch"), witness=w)
    fresh = {"w": np.zeros((3,), np.float32)}
    inst(fresh, np.float32(1.0))
    inst(fresh, np.float32(1.0))           # the stale reuse
    raiser = mod.DonationWitness(raise_on_use=True)
    inst2 = mod.instrument(step, (0,), arg_names=("state", "batch"),
                           witness=raiser)
    inst2(fresh, np.float32(1.0))
    with pytest.raises(mod.UseAfterDonateError) as ei:
        inst2(fresh, np.float32(1.0))
    rep = w.report()
    for ev in rep["events"] + first:
        ev.pop("donate_site", None)
        ev.pop("touch_site", None)
    return marked, first, again, rep, ei.value.event["buffer"]


def test_donatemon_use_after_donate_matches_jax(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_DONATEMON", raising=False)
    for mod in (donatemon, jax_donatemon):
        mod.reset_donation_witness()

        def step(s, b):
            return s
        assert mod.instrument(step, (0,)) is step   # disabled: identity
    ours, theirs = _donate_script(donatemon), _donate_script(jax_donatemon)
    assert ours[:3] == theirs[:3] and ours[4] == theirs[4] == "state"
    assert _strip(ours[3]) == _strip(theirs[3])
    assert ours[3]["events"][0]["rule"] == "GL801"
    assert ours[3]["static_rules"] == theirs[3]["static_rules"]
