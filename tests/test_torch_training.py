"""Training in the PyTorch port against the JAX package, on the CPU: the
losses, the train step (`make_step_fn`), `fit` over an iterator, the
gradient-normalization modes with l2, dropout, configs with their
updater, the optimizer-state converter, and the refusals of what is not
ported yet. Same seeded numpy inputs and JAX weights carried across
with `params_from_numpy` on both sides.

Tolerances: losses within 1e-5 relative; parameters within 2e-5
absolute after three steps (float32 sums in another order, amplified by
Adam's division by √v). Adam runs with ε 1e-3 here: at ε 1e-8 a
near-zero gradient's first update is ±lr whatever its size, so the last
bit of a sum could flip it."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.iterators import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import losses as jax_losses
from deeplearning4j_tpu.nn.config import (
    MultiLayerConfiguration as JaxConf, NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers.feedforward import (
    DenseLayer as JaxDense, OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.optim.listeners import (
    CollectScoresIterationListener as JaxScores,
)
from deeplearning4j_tpu.optim.schedules import (
    ExponentialSchedule as JaxExpSchedule,
)
from deeplearning4j_tpu.optim.updaters import (
    Adam as JaxAdam, Sgd as JaxSgd,
)
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, updater_state_from_numpy,
)
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer
from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.ops.kernel_defaults import attention_policy
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.optim.schedules import ExponentialSchedule
from deeplearning4j_tpu_torch.optim.updaters import Adam

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=0, atol=2e-5)
ADAM = dict(learning_rate=1e-2, epsilon=1e-3)
VARIANTS = {"gpt": dict(),
            "gqa": dict(pos_encoding="rope", norm="rms",
                        ffn_activation="swiglu", num_kv_heads=2)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(port_tree, jax_tree, **tol):
    for name, sub in port_tree.items():
        for k, v in sub.items():
            np.testing.assert_allclose(v.detach().float().numpy(),
                                       np.asarray(jax_tree[name][k]), **tol,
                                       err_msg=f"{name}/{k}")


def _pair(variant, T=16, d=32, blocks=2):
    jconf = JaxTGT(input_shape=(T, 1), d_model=d, num_heads=4,
                   num_blocks=blocks, updater=JaxAdam(**ADAM),
                   **VARIANTS[variant]).conf()
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    return jnet, pnet


def _lm_batch(rng, b, t, vocab=256):
    toks = rng.integers(0, vocab, (b, t + 1))
    return (toks[:, :t, None].astype(np.float32),
            np.eye(vocab, dtype=np.float32)[toks[:, 1:]])


# ---------------------------------------------------------------- losses
LOSSES = [("mcxent", "softmax"), ("mcxent", "sigmoid"), ("xent", "sigmoid"),
          ("xent", "tanh"), ("mse", "identity"), ("l1", "identity"),
          ("l2", "identity"), ("mae", "identity"), ("mape", "identity"),
          ("msle", "relu"), ("hinge", "identity"),
          ("squared_hinge", "identity"), ("kl_divergence", "softmax"),
          ("poisson", "sigmoid"), ("cosine_proximity", "identity"),
          ("wasserstein", "identity")]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,act", LOSSES,
                         ids=[f"{n}-{a}" for n, a in LOSSES])
def test_loss_matches_jax(name, act, masked):
    rng = np.random.default_rng(len(name))
    pre = rng.standard_normal((3, 4, 5)).astype(np.float32)
    lab = rng.random((3, 4, 5)).astype(np.float32)
    if name == "mcxent":
        lab = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (3, 4))]
    if name in ("hinge", "squared_hinge"):
        lab = np.sign(lab - 0.5).astype(np.float32)
    mask = (rng.random((3, 4)) > 0.3).astype(np.float32) if masked else None
    want = jax_losses.LossFunction.get(name)(
        jnp.asarray(lab), jnp.asarray(pre), act,
        None if mask is None else jnp.asarray(mask))
    got = losses.resolve(name)(torch.from_numpy(lab), torch.from_numpy(pre),
                               act,
                               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_sparse_mcxent_and_registry():
    rng = np.random.default_rng(3)
    pre = rng.standard_normal((4, 7)).astype(np.float32)
    idx = rng.integers(0, 7, 4)
    want = jax_losses.sparse_mcxent(jnp.asarray(idx), jnp.asarray(pre))
    got = losses.sparse_mcxent(torch.from_numpy(idx), torch.from_numpy(pre))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    assert losses.LossFunction.names() == jax_losses.LossFunction.names()
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.resolve("nope")


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_three_steps_match_jax(variant):
    jnet, pnet = _pair(variant)
    x, y = _lm_batch(np.random.default_rng(4), 3, 16)
    jstep, pstep = jnet.make_step_fn(), pnet.make_step_fn()
    jp, jo, js = jnet.params_tree, jnet.updater_state, jnet.state_tree
    pp, po, ps = pnet.params_tree, pnet.updater_state, pnet.state_tree
    for i in range(3):
        jp, jo, js, jl, _ = jstep(jp, jo, js, jnp.asarray(i, jnp.int32),
                                  jnp.asarray(x), jnp.asarray(y), None, None,
                                  jax.random.PRNGKey(0), None)
        pp, po, ps, pl, _ = pstep(pp, po, ps, torch.tensor(i),
                                  torch.from_numpy(x), torch.from_numpy(y),
                                  None, None, None, None)
        np.testing.assert_allclose(float(pl), float(jl), **LOSS_TOL)
    assert pp is pnet.params_tree               # updated in place
    _assert_trees(pp, jp, **PARAM_TOL)
    for name in po:
        for mom in ("m", "v"):
            _assert_trees({name: po[name][mom]}, {name: jo[name][mom]},
                          rtol=1e-4, atol=1e-6)


def test_fit_over_an_iterator_matches_jax():
    """Two epochs of two batches: the loss trajectory and the final
    parameters; the port's loss stays on the device until read."""
    jnet, pnet = _pair("gpt")
    x, y = _lm_batch(np.random.default_rng(5), 4, 16)
    js, ps = JaxScores(), CollectScoresIterationListener()
    jnet.listeners.append(js)
    pnet.listeners.append(ps)
    jnet.fit(JaxArrayIterator(x, y, batch_size=2), epochs=2)
    pnet.fit(ArrayDataSetIterator(x, y, batch_size=2), epochs=2)
    assert [i for i, _ in ps.scores] == [i for i, _ in js.scores] == \
        [1, 2, 3, 4]
    np.testing.assert_allclose([s for _, s in ps.scores],
                               [s for _, s in js.scores], **LOSS_TOL)
    assert pnet.iteration == 4 and pnet.epoch == 2
    np.testing.assert_allclose(pnet.score_, jnet.score_, **LOSS_TOL)
    _assert_trees(pnet.params_tree, jnet.params_tree, **PARAM_TOL)
    np.testing.assert_allclose(pnet.score(x, y), jnet.score(x, y),
                               **LOSS_TOL)


def test_loss_is_read_once_an_epoch():
    _, pnet = _pair("gpt", T=8, d=16, blocks=1)
    x, y = _lm_batch(np.random.default_rng(6), 6, 8)
    pnet.fit(x, y, batch_size=2, epochs=2)
    assert pnet._loss_tracker.updates == 6
    assert isinstance(pnet._loss_tracker.peek(), float)


# ------------------------------------------- gradient normalization, l2
MODES = ["none", "renormalize_l2_per_layer", "clip_l2_per_layer",
         "renormalize_l2_per_param_type", "clip_l2_per_param_type",
         "clip_elementwise_absolute_value"]


@pytest.mark.parametrize("mode", MODES)
def test_gradient_normalization_and_l2_match_jax(mode):
    jconf = (JaxNNC.builder().seed(3).updater(JaxSgd(0.5)).l2(1e-2)
             .gradient_normalization(mode, 0.05)
             .list(JaxDense(n_out=6, activation="tanh"),
                   JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
             .set_input_type(JaxInputType.feed_forward(4)).build())
    jnet = JaxNet(jconf).init()
    pconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert pconf.gradient_normalization == mode
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
    jnet.fit(x, y, batch_size=5, epochs=2)
    pnet.fit(x, y, batch_size=5, epochs=2)
    np.testing.assert_allclose(pnet.score_, jnet.score_, **LOSS_TOL)
    _assert_trees(pnet.params_tree, jnet.params_tree, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- dropout
def test_dropout_is_identity_unless_training():
    layer = DenseLayer(n_in=64, n_out=64, dropout=0.4, activation="identity",
                       weight_init="xavier")
    params, _ = layer.init_params(torch.Generator().manual_seed(0), None)
    x = torch.randn(256, 64)
    gen = torch.Generator().manual_seed(1)
    y_eval, _ = layer.apply(params, x, train=False, rng=gen)
    y_norng, _ = layer.apply(params, x, train=True, rng=None)
    want = layer.pre_output(params, x)
    assert torch.equal(y_eval, want) and torch.equal(y_norng, want)


def test_dropout_drop_fraction_and_mean():
    layer = DenseLayer(dropout=0.3)
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(2)
    y = layer._maybe_dropout(x, True, gen)
    frac = float((y == 0).float().mean())
    assert abs(frac - 0.3) < 0.01                 # 200,000 draws
    assert abs(float(y.mean()) - 1.0) < 0.02      # inverted scaling
    assert torch.all((y == 0) | torch.isclose(y, torch.tensor(1 / 0.7)))
    # the same generator state draws the same mask
    y2 = layer._maybe_dropout(x, True, torch.Generator().manual_seed(2))
    assert torch.equal(y, y2)


def test_attention_dropout_on_the_dense_path():
    """Attention dropout keeps the dense path (recorded so), drops the
    weights at its rate, and leaves inference alone."""
    mha = MultiHeadAttention(n_in=8, n_out=8, num_heads=2, causal=True,
                             attn_dropout=0.5, weight_init="xavier",
                             activation="identity")
    params, _ = mha.init_params(torch.Generator().manual_seed(0), None)
    x = torch.randn(2, 6, 8)
    y_inf, _ = mha.apply(params, x)
    y_inf2, _ = mha.apply(params, x, train=True, rng=None)
    assert torch.allclose(y_inf, y_inf2)
    y_tr, _ = mha.apply(params, x, train=True,
                        rng=torch.Generator().manual_seed(3))
    assert not torch.allclose(y_tr, y_inf)
    q = torch.randn(1, 64, 1, 4)
    o = MultiHeadAttention._masked_attention(
        q, q, torch.ones_like(q), None, dropout=0.5,
        rng=torch.Generator().manual_seed(4))
    # each output is the kept weights' sum over ones, scaled by 2: the
    # row sums average 1 over many rows
    assert abs(float(o.mean()) - 1.0) < 0.15


def test_attention_policy_routes():
    assert attention_policy(device="cuda").kind == "flash"
    assert attention_policy(device="cuda", head_dim=128).kind == "flash"
    assert attention_policy(device="cpu").kind == "flash"
    w = attention_policy(device="cuda", window=4)
    assert (w.kind, w.reason) == ("banded",
                                  "the hand-written CUDA banded kernels")
    assert attention_policy(device="cpu", window=4).kind == "banded"
    assert attention_policy(device="cuda", window=4, masked=True).kind == \
        "dense"
    assert attention_policy(device="cuda", masked=True).kind == "dense"
    assert attention_policy(device="cuda", dropout=True).kind == "dense"


def test_attention_policy_refuses_head_dims_past_the_kernels_on_the_card():
    # a CUDA tensor never falls back to a plain version; the CPU's plain
    # versions take any head dim
    with pytest.raises(ValueError, match="head dim 160"):
        attention_policy(device="cuda", head_dim=160)
    assert attention_policy(device="cpu", head_dim=160).kind == "flash"


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,item", [
    (dict(checkpointer=object()), "A6"),
    (dict(resume="auto"), "A6"),
    (dict(preemption=True), "A6"),
    (dict(stop_fn=lambda: False), "A6")])
def test_fit_refuses_what_is_not_ported(kw, item):
    _, pnet = _pair("gpt", T=8, d=16, blocks=1)
    x, y = _lm_batch(np.random.default_rng(8), 2, 8)
    with pytest.raises(NotImplementedError, match=item):
        pnet.fit(x, y, **kw)


@pytest.mark.parametrize("field,value,item", [
    ("optimization_algo", "lbfgs", "A1")])
def test_fit_refuses_unported_config(field, value, item):
    import dataclasses

    _, pnet = _pair("gpt", T=8, d=16, blocks=1)
    pnet.conf = dataclasses.replace(pnet.conf, **{field: value})
    x, y = _lm_batch(np.random.default_rng(9), 2, 8)
    with pytest.raises(NotImplementedError, match=item):
        pnet.fit(x, y)


def test_fit_with_gradient_checkpointing_matches_jax():
    """Gradient checkpointing (once refused naming A4): 2 Adam steps of
    the checkpointed transformer against JAX's checkpointed steps."""
    import dataclasses

    jnet, _ = _pair("gqa", T=8, d=16, blocks=2)
    jnet.conf = dataclasses.replace(jnet.conf, gradient_checkpointing=True)
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    assert pnet.conf.gradient_checkpointing
    rng = np.random.default_rng(10)
    for _ in range(2):
        x, y = _lm_batch(rng, 2, 8)
        jnet.fit(x, y, batch_size=2)
        pnet.fit(x, y, batch_size=2)
        np.testing.assert_allclose(pnet.score_, float(jnet.score_),
                                   **LOSS_TOL)
    _assert_trees(pnet.params_tree, jnet.params_tree, **PARAM_TOL)


# ------------------------------------------------------------ config serde
def test_config_json_with_its_updater_both_ways():
    sched = JaxExpSchedule(initial=1e-2, decay_rate=0.99)
    jconf = JaxTGT(input_shape=(16, 1), d_model=32, num_heads=4,
                   num_blocks=2, updater=JaxAdam(learning_rate=sched,
                                                 beta2=0.98)).conf()
    pconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert pconf.updater == Adam(learning_rate=ExponentialSchedule(
        initial=1e-2, decay_rate=0.99), beta2=0.98)
    assert all(isinstance(l.updater, Adam) for l in pconf.layers)
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    assert JaxConf.from_json(pconf.to_json()) == jconf
    # the zoo default, Adam(3e-4), on both sides
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    own = TextGenerationTransformer(input_shape=(16, 1), d_model=32,
                                    num_heads=4, num_blocks=2).conf()
    assert own.updater == Adam(3e-4)
    assert json.loads(own.to_json()) == json.loads(
        JaxTGT(input_shape=(16, 1), d_model=32, num_heads=4,
               num_blocks=2).conf().to_json())


def test_schedule_values_match_jax():
    from deeplearning4j_tpu.optim import schedules as js
    from deeplearning4j_tpu_torch.optim import schedules as ps

    cases = [("StepSchedule", dict(initial=0.1, decay_rate=0.5,
                                   step_size=3)),
             ("ExponentialSchedule", dict(initial=0.1, decay_rate=0.9)),
             ("InverseSchedule", dict(initial=0.1, gamma=0.1, power=0.75)),
             ("PolySchedule", dict(initial=0.1, power=2.0, max_iter=20)),
             ("SigmoidSchedule", dict(initial=0.1, gamma=0.5, center=5)),
             ("MapSchedule", dict(initial=0.1, schedule={3: 0.05, 7: 0.01})),
             ("WarmupCosineSchedule", dict(peak=0.1, warmup_steps=4,
                                           total_steps=12))]
    for name, kw in cases:
        for step in (0, 1, 4, 9, 30):
            want = float(getattr(js, name)(**kw).value(step))
            got = float(getattr(ps, name)(**kw).value(torch.tensor(step)))
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


# ------------------------------------------------- optimizer state across
def test_updater_state_from_numpy_resumes_a_trajectory():
    """Two JAX steps, then params and Adam moments carried to the port:
    the third step agrees on both sides."""
    jnet, pnet = _pair("gpt")
    x, y = _lm_batch(np.random.default_rng(10), 2, 16)
    jnet.fit(x, y, batch_size=2, epochs=2)
    params_from_numpy(pnet, _np(jnet.params_tree))
    updater_state_from_numpy(pnet, _np(jnet.updater_state))
    pnet.iteration = jnet.iteration
    jnet.fit(x, y, batch_size=2, epochs=1)
    pnet.fit(x, y, batch_size=2, epochs=1)
    np.testing.assert_allclose(pnet.score_, jnet.score_, **LOSS_TOL)
    _assert_trees(pnet.params_tree, jnet.params_tree, **PARAM_TOL)


def test_updater_state_from_numpy_checks_names_and_shapes():
    jnet, pnet = _pair("gpt", T=8, d=16, blocks=1)
    tree = _np(jnet.updater_state)
    name = next(iter(tree))
    with pytest.raises(KeyError):
        updater_state_from_numpy(pnet, {k: v for k, v in tree.items()
                                        if k != name})
    bad = {k: {m: dict(t) for m, t in v.items()} for k, v in tree.items()}
    key = next(iter(bad[name]["m"]))
    bad[name]["m"][key] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError):
        updater_state_from_numpy(pnet, bad)
    with pytest.raises(KeyError):
        updater_state_from_numpy(pnet, {k: {"m": v["m"]}
                                        for k, v in tree.items()})


def test_embedding_layer_matches_jax():
    from deeplearning4j_tpu.nn.layers.feedforward import (
        EmbeddingLayer as JaxEmbedding,
    )
    from deeplearning4j_tpu_torch.nn.layers import EmbeddingLayer

    kw = dict(n_in=11, n_out=4, activation="tanh", weight_init="xavier",
              bias_init=0.1)
    params, _ = JaxEmbedding(**kw).init_params(
        jax.random.PRNGKey(0), JaxInputType.feed_forward(1))
    idx = np.array([[3], [0], [10]], np.float32)
    want, _ = JaxEmbedding(**kw).apply(params, jnp.asarray(idx))
    got, _ = EmbeddingLayer(**kw).apply(
        {k: torch.tensor(np.asarray(v)) for k, v in params.items()},
        torch.from_numpy(idx), train=True,
        rng=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_listeners_report_scores_and_throughput():
    from deeplearning4j_tpu_torch.optim.listeners import (
        PerformanceListener, ScoreIterationListener,
    )

    _, pnet = _pair("gpt", T=8, d=16, blocks=1)
    x, y = _lm_batch(np.random.default_rng(12), 6, 8)
    said, perf = [], []
    pl = PerformanceListener(frequency=1, report=perf.append)
    pnet.listeners += [ScoreIterationListener(2, out=said.append), pl]
    pnet.fit(x, y, batch_size=2, epochs=1)
    assert len(said) == 1 and said[0].startswith("Score at iteration 2 is")
    assert len(perf) == 2            # iterations 2 and 3 (1 sets the clock)
    assert pl.last_tokens_per_sec == pytest.approx(
        8 * pl.last_samples_per_sec)
    assert pl.last_samples_per_sec == pytest.approx(
        2 * pl.last_batches_per_sec)
