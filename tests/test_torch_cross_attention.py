"""`CrossAttentionVertex` and `MultiDataSet` feeding in the PyTorch port
against the JAX package, on the CPU, in float64: the vertex's forward
and gradients on the flash path (no key mask: the plain B3a/B3b/B3c on
the CPU, at Tq != Tk) and on the key-mask path, its mask errors, its
configuration from JAX's JSON, `examples/seq2seq_cross_attention.py`'s
flow at tiny widths trained from a `MultiDataSet` (losses and weights
after 3 Adam steps, with and without a key mask), `score`, K 4 against
K 1, `MultiDataSet.save`/`load` both ways, and the failure of a plain
`DataSet` fed to a two-input graph. Tolerance 1e-9 (float64 sums in
another order); weights after Adam steps 1e-8 absolute and 1e-7
relative, and what is computed from them (Adam divides by √v, so a
gradient near zero turns a last-bit difference into a larger step)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import (
    DataSet as JaxDataSet, MultiDataSet as JaxMultiDataSet,
)
from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.graph import (
    CrossAttentionVertex as JaxCrossAttention,
)
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers.recurrent import (
    RnnOutputLayer as JaxRnnOutput,
)
from deeplearning4j_tpu.optim.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraphConfiguration, CrossAttentionVertex,
)
from deeplearning4j_tpu_torch.optim.executor import batch_signature

TOL = dict(rtol=1e-9, atol=1e-9)
PARAM_TOL = dict(rtol=1e-7, atol=1e-8)
B, TQ, TK, DQ, DKV = 3, 5, 7, 6, 10


def _vertex_case(tq, tk, key_mask_input, seed=0):
    rng = np.random.default_rng(seed)
    kw = dict(num_heads=2, n_out=8, key_mask_input=key_mask_input)
    jv = JaxCrossAttention(**kw)
    params, _ = jv.init_params(
        jax.random.PRNGKey(seed),
        [JaxInputType.recurrent(DQ, tq), JaxInputType.recurrent(DKV, tk)],
        jnp.float64)
    x = rng.standard_normal((B, tq, DQ))
    ctx = rng.standard_normal((B, tk, DKV))
    w = rng.standard_normal((B, tq, 8))
    return jv, CrossAttentionVertex(**kw), params, x, ctx, w


MASKS = ["none", "key_mask_input", "implicit", "query_length"]


@pytest.mark.parametrize("masking", MASKS)
def test_forward_and_gradients_match_jax(masking):
    """No mask (flash), a key mask by name or by its length (dense), a
    query-length mask (ignored: the loss masks outputs)."""
    jv, pv, params, x, ctx, w = _vertex_case(
        TQ, TK, "enc" if masking == "key_mask_input" else None)
    mask = None
    if masking in ("key_mask_input", "implicit"):
        mask = np.ones((B, TK))
        mask[0, 4:] = 0.0
        mask[2, 1:] = 0.0
    elif masking == "query_length":
        mask = np.ones((B, TQ))
        mask[1, 2:] = 0.0

    def jloss(p, x_, c_):
        y, _ = jv.apply(p, [x_, c_],
                        mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(y * w), y

    (_, yj), (gp, gx, gc) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(ctx))
    pp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(ctx).requires_grad_(True)
    yp, _ = pv.apply(pp, [xt, ct], mask=None if mask is None
                     else torch.from_numpy(mask))
    (yp * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(yp.detach().numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc), **TOL)
    for k in params:
        np.testing.assert_allclose(pp[k].grad.numpy(), np.asarray(gp[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("tq,tk,name,mask_len,match", [
    (5, 5, None, 5, "ambiguous mask"),
    (5, 7, None, 4, "matches neither"),
    (5, 7, "enc", 5, "key_mask_input mask length")],
    ids=["ambiguous", "neither", "named_wrong_length"])
def test_mask_errors_are_jaxs(tq, tk, name, mask_len, match):
    jv, pv, params, x, ctx, _ = _vertex_case(tq, tk, name)
    mask = np.ones((B, mask_len))
    with pytest.raises(ValueError, match=match) as jerr:
        jv.apply(params, [jnp.asarray(x), jnp.asarray(ctx)],
                 mask=jnp.asarray(mask))
    with pytest.raises(ValueError, match=match) as perr:
        pv.apply({k: torch.from_numpy(np.array(v))
                  for k, v in params.items()},
                 [torch.from_numpy(x), torch.from_numpy(ctx)],
                 mask=torch.from_numpy(mask))
    assert str(perr.value) == str(jerr.value)


# ------------------------------------------------ the seq2seq flow
V, T = 5, 6


def _seq2seq_conf(key_mask_input=None):
    """`examples/seq2seq_cross_attention.py`'s graph, width 16, in
    float64."""
    conf = (JaxNNC.builder().seed(0).updater(JaxAdam(1e-2))
            .activation("relu").graph_builder()
            .add_inputs("dec", "enc")
            .add_layer("enc_ff", JaxDense(n_out=16), "enc")
            .add_layer("dec_ff", JaxDense(n_out=16), "dec")
            .add_vertex("xattn", JaxCrossAttention(
                num_heads=2, n_out=16, key_mask_input=key_mask_input),
                "dec_ff", "enc_ff")
            .add_layer("out", JaxRnnOutput(n_out=V, activation="softmax"),
                       "xattn")
            .set_outputs("out")
            .set_input_types(JaxInputType.recurrent(T, T),
                             JaxInputType.recurrent(V + T, T))
            .build())
    return dataclasses.replace(conf, dtype="float64")


def _seq2seq_data(seed, n=8, masked=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (n, T))
    pos = np.tile(np.eye(T)[None], (n, 1, 1))
    enc = np.concatenate([np.eye(V)[tokens], pos], -1)
    y = np.eye(V)[tokens[:, ::-1]]
    fmasks = None
    if masked:
        m = np.ones((n, T))
        m[::2, T - 2:] = 0.0
        fmasks = [None, m]
    return pos, enc, y, fmasks


def _graphs(key_mask_input=None):
    jconf = _seq2seq_conf(key_mask_input)
    jnet = JaxGraph(jconf).init()
    pconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    pnet = ComputationGraph(pconf, device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return jconf, jnet, pnet


def test_configuration_loads_from_jax_json():
    jconf, _, pnet = _graphs("enc")
    assert isinstance(pnet.conf.vertices["xattn"], CrossAttentionVertex)
    assert pnet.conf.vertices["xattn"].key_mask_input == "enc"
    assert pnet.conf.to_json() == jconf.to_json()


@pytest.mark.parametrize("masked", [False, True], ids=["flash", "key_mask"])
def test_seq2seq_trains_from_a_multidataset_as_jax(masked):
    """3 Adam steps, one MultiDataSet each: the losses and the weights
    after them; the key mask reaches the vertex by its input's name."""
    _, jnet, pnet = _graphs("enc" if masked else None)
    for step in range(3):
        dec, enc, y, fm = _seq2seq_data(step, masked=masked)
        jnet.fit(JaxMultiDataSet([dec, enc], [y], fm))
        pnet.fit(MultiDataSet([dec, enc], [y], fm))
        np.testing.assert_allclose(pnet.score_, float(jnet.score_), **TOL)
    want = jax.tree_util.tree_map(np.asarray, jnet.params_tree)
    for v, sub in pnet.params_tree.items():
        for k, t in sub.items():
            np.testing.assert_allclose(t.numpy(), want[v][k], **PARAM_TOL,
                                       err_msg=f"{v}/{k}")
    dec, enc, y, fm = _seq2seq_data(9, masked=masked)
    np.testing.assert_allclose(
        pnet.score(MultiDataSet([dec, enc], [y], fm)),
        jnet.score(JaxMultiDataSet([dec, enc], [y], fm)), **PARAM_TOL)
    np.testing.assert_allclose(pnet.output(dec, enc).numpy(),
                               np.asarray(jnet.output(dec, enc)),
                               **PARAM_TOL)


def test_k4_multidataset_windows_equal_k1():
    _, _, k1 = _graphs()
    _, _, k4 = _graphs()
    batches = []
    for seed in range(4):
        dec, enc, y, _ = _seq2seq_data(seed)
        batches.append(MultiDataSet([dec, enc], [y]))
    assert len({batch_signature(b) for b in batches}) == 1
    assert batch_signature(batches[0]) != batch_signature(
        MultiDataSet(batches[0].features, batches[0].labels,
                     [None, np.ones((8, T))]))
    k1.fit(batches)
    k4.fit(batches, steps_per_dispatch=4)
    assert k4.fit_stats["eager_steps"] == 4
    for v, sub in k1.params_tree.items():
        for k, t in sub.items():
            assert torch.equal(t, k4.params_tree[v][k]), f"{v}/{k}"


def test_a_dataset_fed_to_a_two_input_graph_fails_as_jaxs():
    _, jnet, pnet = _graphs()
    dec, _, y, _ = _seq2seq_data(0)
    with pytest.raises(KeyError, match="enc"):
        jnet.fit(JaxDataSet(dec, y))
    with pytest.raises(KeyError, match="enc"):
        pnet.fit(DataSet(dec, y))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_multidataset_save_and_load_both_ways(tmp_path, writer):
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((4, 3, 2)), rng.standard_normal((4, 5))]
    labels = [rng.standard_normal((4, 2))]
    fmasks = [None, np.ones((4, 5))]
    cls, other = ((JaxMultiDataSet, MultiDataSet) if writer == "jax"
                  else (MultiDataSet, JaxMultiDataSet))
    path = cls(feats, labels, fmasks).save(tmp_path / "batch")
    assert path.endswith(".npz")
    back = other.load(path)
    for got, want in zip(back.features + back.labels,
                         feats + labels):
        np.testing.assert_array_equal(got, want)
    assert back.features_masks[0] is None
    np.testing.assert_array_equal(back.features_masks[1], fmasks[1])
    assert back.labels_masks is None
