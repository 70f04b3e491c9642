"""The port's data parallelism against the JAX package's (A6, first
part): the spine's placements, `ParallelWrapper` on 2 gloo ranks (one
module-scoped group, `torch_parallel_ranks.py`) against JAX's on a
2-device mesh (`make_mesh({"data": 2}, devices=...)` over the first two
of conftest's devices: the same data size, so a partial batch pads the
same rows), the early-
stopping trainer over it, the threshold-coded exchange's bytes, and
the refusal of parameter sharding rules (FSDP: A6's second part).

Tolerances: float32 training, the same global batches and initial
weights; the ranks sum their gradients in another order than XLA's
one-pass reduction, so parameters, moments and losses agree within
2e-5 of the largest |JAX value| (1.0 at least); the port's own K 2 and
K 1 runs are bit-equal. The ResNet bottleneck (fused conv+BN layers
through `ops/conv_fused`, a plain batch norm, a residual add) trains in
float64, where 2 ranks, one process and JAX's 2-device step differ only
by float64 rounding: within 1e-10 of each leaf's largest |value| (1.0
at least) and 1e-12 relative on losses; a batch statistic taken over
one rank's rows instead of the global batch moves them by 1e-3 or more.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import InputType as JaxInputType
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.data.iterators import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.graph import ElementWiseVertex as JaxAdd
from deeplearning4j_tpu.nn.layers import (
    ActivationLayer as JaxActivation, BatchNormalization as JaxBN,
    ConvolutionLayer as JaxConv, DenseLayer as JaxDense,
    FusedConvBNLayer as JaxFusedConvBN, GlobalPoolingLayer as JaxGlobalPool,
    OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.optim.listeners import (
    TrainingListener as JaxListener,
)
from deeplearning4j_tpu.optim.updaters import Adam as JaxAdam
from deeplearning4j_tpu.optim.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxPW
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel.accumulation import (
    SharedGradientsExchange as JaxExchange,
)
from deeplearning4j_tpu.parallel.mesh import MeshContext as JaxMC
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from deeplearning4j_tpu.parallel.sharding import fsdp_rules as jax_fsdp
from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.optim.listeners import TrainingListener
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.accumulation import (
    SharedGradientsExchange,
)
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec
from deeplearning4j_tpu_torch.parallel.sharding import fsdp_rules
from torch_parallel_ranks import assemble, document, launch, results

WORLD = 2
RTOL_SCALE = 2e-5
F64_SCALE, F64_LOSS_RTOL = 1e-10, 1e-12
SHAPES = {"a": {"W": [8, 16], "b": [16]},
          "b": {"W": [4, 6], "g": [3, 6], "b": [3]}}


def _conf(updater, bn=True):
    layers = [JaxDense(n_out=16)]
    if bn:
        layers.append(JaxBN())
    layers.append(JaxOutput(n_out=4, activation="softmax", loss="mcxent"))
    return (JaxNNC.builder().seed(11).updater(updater).activation("tanh")
            .list(*layers)
            .set_input_type(JaxInputType.feed_forward(8)).build())


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _jax_mesh(devices):
    return jax_mesh({"data": WORLD}, devices=devices[:WORLD])


class _JaxLosses(JaxListener):
    def __init__(self):
        self.values = []

    def iteration_done(self, model, iteration, epoch, score):
        self.values.append(float(score))


def _np_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_np_leaves(v, f"{prefix}{k}/"))
        elif hasattr(v, "shape"):
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _bottleneck_conf():
    """A ResNet-50 stem and conv block at 8x8, in float64: a plain conv
    and batch norm, then the block's fused conv+BN layers (a 1x1, a 3x3
    and a 1x1 of the main path, a 1x1 projection shortcut), the residual
    add, global pooling, a 4-class softmax."""
    g = (JaxNNC.builder().seed(7).updater(JaxNesterovs(0.05, 0.9))
         .weight_init("relu").graph_builder().add_inputs("input")
         .set_input_types(JaxInputType.convolutional(8, 8, 3)))
    g.add_layer("stem_conv", JaxConv(n_out=8, kernel=(3, 3),
                                     convolution_mode="same",
                                     activation="identity", has_bias=False),
                "input")
    g.add_layer("stem_bn", JaxBN(activation="relu"), "stem_conv")
    x = "stem_bn"
    for name, n_out, kernel, act in (("a", 4, (1, 1), "relu"),
                                     ("b", 4, (3, 3), "relu"),
                                     ("c", 12, (1, 1), "identity")):
        g.add_layer(name, JaxFusedConvBN(n_out=n_out, kernel=kernel,
                                         activation=act), x)
        x = name
    g.add_layer("sc", JaxFusedConvBN(n_out=12, kernel=(1, 1),
                                     activation="identity"), "stem_bn")
    g.add_vertex("add", JaxAdd(op="add"), "c", "sc")
    g.add_layer("out", JaxActivation(activation="relu"), "add")
    g.add_layer("pool", JaxGlobalPool(pooling="avg"), "out")
    g.add_layer("output", JaxOutput(n_out=4, activation="softmax",
                                    loss="mcxent"), "pool")
    g.set_outputs("output")
    return dataclasses.replace(g.build(), dtype="float64")


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8, 8, 3)),
            np.eye(4)[rng.integers(0, 4, n)])


# each wrapper case: (updater, rows, batch, epochs, shard, k)
FIT_CASES = {
    "full_nesterovs": (JaxNesterovs(0.1, 0.9), 24, 8, 2, True, 1),
    "partial_adam": (JaxAdam(1e-2), 23, 8, 2, True, 1),
    "replicated_nesterovs": (JaxNesterovs(0.1, 0.9), 24, 8, 2, False, 1),
    "k2_nesterovs": (JaxNesterovs(0.1, 0.9), 32, 8, 1, True, 2),
    "k1_nesterovs": (JaxNesterovs(0.1, 0.9), 32, 8, 1, True, 1),
}
# the float64 bottleneck: 16 images, global batches of 8 (4 a rank), 2
# epochs
BOTTLENECK = (16, 8, 2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, devices8):
    """The JAX runs, and the port's on one 2-rank gloo group for every
    case."""
    d = tmp_path_factory.mktemp("parallel")
    inputs, cases, jax_out = {}, [], {}
    for name, (up, n, batch, epochs, shard, k) in FIT_CASES.items():
        conf = _conf(up)
        jnet = JaxNet(conf).init()
        for key, v in _np_leaves(jnet.params_tree).items():
            inputs[f"{name}/{key}"] = v
        x, y = _data(n, seed=n)
        inputs[f"{name}.x"], inputs[f"{name}.y"] = x, y
        pw = JaxPW(jnet, mesh=_jax_mesh(devices8), prefetch_buffer=0,
                   shard_opt_state=shard)
        losses = _JaxLosses()
        jnet.listeners.append(losses)
        pw.fit(x, y, epochs=epochs, batch_size=batch, steps_per_dispatch=k)
        jax_out[name] = (jnet, losses.values)
        cases.append({"kind": "fit", "name": name, "conf": conf.to_json(),
                      "weights": name, "x": f"{name}.x", "y": f"{name}.y",
                      "epochs": epochs, "batch": batch, "shard": shard,
                      "k": k})
    # the float64 ResNet bottleneck through the fused conv+BN layers
    conf = _bottleneck_conf()
    jnet = JaxGraph(conf).init()
    for key, v in _np_leaves(jnet.params_tree).items():
        inputs[f"bottleneck/{key}"] = v
    n, batch, epochs = BOTTLENECK
    x, y = _images(n, seed=3)
    inputs["bottleneck.x"], inputs["bottleneck.y"] = x, y
    losses = _JaxLosses()
    jnet.listeners.append(losses)
    JaxPW(jnet, mesh=_jax_mesh(devices8), prefetch_buffer=0).fit(
        x, y, epochs=epochs, batch_size=batch)
    jax_out["bottleneck"] = (jnet, losses.values)
    cases.append({"kind": "fit", "name": "bottleneck", "graph": True,
                  "conf": conf.to_json(), "weights": "bottleneck",
                  "x": "bottleneck.x", "y": "bottleneck.y",
                  "epochs": epochs, "batch": batch})
    # the early-stopping trainer over the wrapper
    conf = _conf(JaxNesterovs(0.05, 0.9), bn=False)
    jnet = JaxNet(conf).init()
    for key, v in _np_leaves(jnet.params_tree).items():
        inputs[f"es/{key}"] = v
    x, y = _data(16, seed=5)
    inputs["es.x"], inputs["es.y"] = x, y
    cfg = jes.EarlyStoppingConfiguration(
        epoch_termination_conditions=[jes.MaxEpochsTerminationCondition(3)])
    res = jes.EarlyStoppingParallelTrainer(
        cfg, jnet, JaxArrayIterator(x, y, 8), mesh=_jax_mesh(devices8)).fit()
    jax_out["es"] = (jnet, res)
    jax_out["inputs"] = inputs
    cases.append({"kind": "earlystopping", "name": "es",
                  "conf": conf.to_json(), "weights": "es", "x": "es.x",
                  "y": "es.y", "batch": 8})
    cases.append({"kind": "spine", "name": "spine", "shapes": SHAPES})
    np.savez(d / "inputs.npz", **inputs)
    import json
    (d / "cases.json").write_text(json.dumps({"parallel": cases}))
    launch("parallel", WORLD, str(d))
    return str(d), jax_out


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_SCALE * scale,
                               err_msg=what)


# ------------------------------------------------------------- the spine
def test_mesh_spec_resolves_as_jax():
    for axes, n in (({"data": -1}, 8), ({"data": 2, "model": -1}, 8),
                    ({"data": 4}, 4)):
        assert MeshSpec(axes).resolve(n) == JaxMeshSpec(axes).resolve(n)
    for axes, n in (({"data": -1, "model": -1}, 8), ({"data": 3}, 8)):
        with pytest.raises(ValueError):
            JaxMeshSpec(axes).resolve(n)
        with pytest.raises(ValueError):
            MeshSpec(axes).resolve(n)


@pytest.mark.parametrize("rules", ["none", "fsdp"])
def test_moment_specs_and_bounds_match_jax(ranks, rules, devices8):
    """`moment_spec`, the param spec and each rank's bounds of every
    leaf, without rules and under `fsdp_rules`, equal JAX's on 2
    devices (so the checkpoints' shard bounds agree)."""
    d, _ = ranks
    mesh = _jax_mesh(devices8)
    ctx = JaxMC(mesh, jax_fsdp(["a", "b"]) if rules == "fsdp" else None)
    for r in range(WORLD):
        doc = document(d, "spine", r)[rules]
        for layer, sub in SHAPES.items():
            for p, shape in sub.items():
                leaf = np.zeros(shape, np.float32)
                got = doc[f"{layer}/{p}"]
                assert tuple(got["moment"]) == tuple(
                    ctx.moment_spec(layer, p, leaf)), (layer, p)
                assert tuple(got["param"]) == tuple(
                    ctx.param_shardings({layer: {p: leaf}})[layer][p].spec)
                sh = ctx.opt_shardings({layer: {"m": {p: leaf}}})
                idx = sh[layer]["m"][p].devices_indices_map(tuple(shape))[
                    mesh.devices.flat[r]]
                want = [[0 if s.start is None else s.start,
                         dim if s.stop is None else s.stop]
                        for s, dim in zip(idx, shape)]
                assert got["bounds"] == want, (layer, p, r)


def test_each_rank_takes_its_rows(ranks):
    d, _ = ranks
    rows = [document(d, "spine", r)["batch_rows"] for r in range(WORLD)]
    assert rows == [[0.0, 2.0, 4.0], [6.0, 8.0, 10.0]]


# ------------------------------------------------------ the wrapper's fits
@pytest.mark.parametrize("name", [n for n in FIT_CASES if n != "k1_nesterovs"])
def test_parallel_wrapper_matches_jax_on_two_devices(ranks, name):
    """Losses every step, parameters, batch-norm statistics and the
    moments (reassembled from both ranks' slices) against JAX's wrapper
    on a 2-device mesh: a full and a partial batch, Adam and Nesterovs,
    sharded and replicated moments, K 2."""
    d, jax_out = ranks
    jnet, jlosses = jax_out[name]
    parts = results(d, name, WORLD)
    for r in range(WORLD):
        _close(parts[r]["losses"], np.asarray(jlosses), f"{name} losses")
    for key, want in _np_leaves(jnet.params_tree).items():
        for r in range(WORLD):
            _close(parts[r][f"params/{key}"], want, f"{name} {key}")
    for key, want in _np_leaves(jnet.state_tree).items():
        _close(parts[0][f"state/{key}"], want, f"{name} state {key}")
    for key, want in _np_leaves(jnet.updater_state).items():
        _close(assemble(parts, f"updater/{key}", WORLD), want,
               f"{name} updater {key}")


def test_sharded_moments_hold_half_and_match_replicated(ranks):
    """With `shard_opt_state` each rank keeps half of every split moment;
    the sharded run's parameters equal the replicated run's to the
    wrapper's tolerance (PERF_NOTES "Sharding spine")."""
    d, _ = ranks
    sharded = results(d, "full_nesterovs", WORLD)
    whole = results(d, "replicated_nesterovs", WORLD)
    for key in [k for k in sharded[0] if k.startswith("updater/")
                and "@" not in k]:
        assert sharded[0][key].size * WORLD == whole[0][key].size, key
    jnet, _ = ranks[1]["replicated_nesterovs"]
    for key in _np_leaves(jnet.params_tree):
        _close(sharded[0][f"params/{key}"], whole[0][f"params/{key}"],
               key)


def test_k2_equals_k1_bit_for_bit(ranks):
    d, _ = ranks
    k2, k1 = results(d, "k2_nesterovs", WORLD), results(d, "k1_nesterovs",
                                                        WORLD)
    for r in range(WORLD):
        for key in k1[r]:
            np.testing.assert_array_equal(k2[r][key], k1[r][key], key)


def test_early_stopping_parallel_trainer_matches_jax(ranks):
    d, jax_out = ranks
    jnet, res = jax_out["es"]
    doc = document(d, "es", 0)
    assert doc["reason"] == res.termination_reason
    assert doc["epochs"] == res.total_epochs
    assert doc["best_epoch"] == res.best_model_epoch
    for ep, s in res.score_vs_epoch.items():
        assert doc["scores"][str(ep)] == pytest.approx(s, rel=2e-5)
    parts = results(d, "es", WORLD)
    for key, want in _np_leaves(jnet.params_tree).items():
        _close(parts[0][f"params/{key}"], want, key)


# ------------------------------------------------- threshold exchange
def test_threshold_exchange_bytes_match_jax():
    """Every message of a 3-worker exchange, encoded by the port's own
    native codec, is JAX's: the same packed indices and signs, and the
    same targets after `collect`; residuals carry over rounds."""
    rng = np.random.default_rng(4)
    ours, theirs = SharedGradientsExchange(3, 64, 0.05), \
        JaxExchange(3, 64, 0.05)
    seen = {"port": [], "jax": []}
    for ex, tag in ((ours, "port"), (theirs, "jax")):
        for acc in ex.accumulators:
            put = acc.receive_update

            def spy(packed, threshold, n, put=put, tag=tag):
                seen[tag].append(np.asarray(packed).tobytes())
                put(packed, threshold, n)
            acc.receive_update = spy
    grads = [rng.standard_normal(64).astype(np.float32) * 0.04
             for _ in range(6)]
    for rnd in range(2):
        for w in range(3):
            assert ours.publish(w, grads[w + 3 * rnd]) == \
                theirs.publish(w, grads[w + 3 * rnd])
    assert seen["port"] == seen["jax"] and seen["port"]
    for w in range(3):
        a, b = np.zeros(64, np.float32), np.zeros(64, np.float32)
        assert ours.collect(w, a) == theirs.collect(w, b)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.handlers[w].residual,
                                      theirs.handlers[w].residual)


# ------------------------------------------- the fused bottleneck, float64
def _close64(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_SCALE * scale,
                               err_msg=what)


def test_bottleneck_two_ranks_match_one_process_and_jax(ranks):
    """The float64 ResNet bottleneck on 2 gloo ranks, its batch
    statistics over the data group (B7a/B7b's Σy and Σy², the BN
    backward's two sums and the plain batch norm's moments, each summed
    over the ranks), against one process on the same global batches and
    against JAX's wrapper on a 2-device mesh: losses, parameters,
    running statistics and the (reassembled) moments."""
    d, jax_out = ranks
    inputs = jax_out["inputs"]
    jnet, jlosses = jax_out["bottleneck"]
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    assert net.dtype == torch.float64
    tree = {layer: {} for layer in net.params_tree}   # parameterless too
    for key, v in inputs.items():
        if key.startswith("bottleneck/"):
            layer, pname = key[len("bottleneck/"):].split("/", 1)
            tree.setdefault(layer, {})[pname] = v
    params_from_numpy(net, tree)

    class Losses(TrainingListener):
        def __init__(self):
            self.values = []

        def iteration_done(self, model, iteration, epoch, score):
            self.values.append(float(score))

    def trees(losses, model):
        out = {"losses": np.asarray(losses)}
        for what in ("params", "state", "updater"):
            tree = getattr(model, "updater_state" if what == "updater"
                           else f"{what}_tree")
            out.update({f"{what}/{k}": v
                        for k, v in _np_leaves(tree).items()})
        return out

    n, batch, epochs = BOTTLENECK
    rec = Losses()
    net.listeners.append(rec)
    net.fit(inputs["bottleneck.x"], inputs["bottleneck.y"], epochs=epochs,
            batch_size=batch)
    parts = results(d, "bottleneck", WORLD)
    for ref, what in ((trees(rec.values, net), "one process"),
                      (trees(jlosses, jnet), "JAX")):
        assert len(ref["losses"]) == epochs * n // batch
        for r in range(WORLD):
            np.testing.assert_allclose(parts[r]["losses"], ref["losses"],
                                       rtol=F64_LOSS_RTOL,
                                       err_msg=f"losses vs {what}")
        for key, want in ref.items():
            if key.startswith("params/"):
                for r in range(WORLD):
                    _close64(parts[r][key], want, f"{key} vs {what}")
            elif key.startswith("state/"):
                _close64(parts[0][key], want, f"{key} vs {what}")
            elif key.startswith("updater/"):
                _close64(assemble(parts, key, WORLD), want,
                         f"{key} vs {what}")


# --------------------------------------------------------------- refusals
def test_parameter_sharding_rules_are_refused_naming_a6():
    """FSDP's rules (and any rule that splits a parameter) are refused
    before any process group is joined: the port's wrapper keeps whole
    parameters on every rank, which is not what the rules ask for."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration

    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _conf(JaxAdam(1e-2)).to_json()), device="cpu").init()
    with pytest.raises(NotImplementedError, match="A6, its second part"):
        ParallelWrapper(net, param_rules=fsdp_rules(list(net.params_tree)))
    assert not torch.distributed.is_initialized()
