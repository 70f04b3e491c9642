"""Gradient checkpointing (`conf.gradient_checkpointing`) in the PyTorch
port, on the CPU, in float64, on both runtimes: train steps against the
JAX package's checkpointed ones (Sgd, so each parameter's change is its
gradient times the rate; within 1e-9, and with RoPE 1e-7 absolute and
1e-6 relative: its float32 angles' cos and sin may differ in the last
bit between the packages), bit for bit against the port's
un-checkpointed steps, with dropout too (the recompute replays the
forward's masks: `nn/layers/base.RngTape`), the recompute itself (each
checkpointed block runs twice a step), and K 4 against K 1."""

import dataclasses

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.optim.updaters import Sgd as JaxSgd
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.layers import TransformerEncoderBlock

from torch_stepping_pairs import RUNTIMES, np_tree, pair, port_twin, tgt_conf

TOL = {"text_generation": dict(rtol=0, atol=1e-9),
       "modern_llm": dict(rtol=1e-6, atol=1e-7)}


def _batch(seed, b=3, t=8, vocab=11):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t + 1))
    return toks[:, :t, None].astype(np.float64), np.eye(vocab)[toks[:, 1:]]


def _conf(config, dropout=None):
    conf = tgt_conf(config, T=8, updater=JaxSgd(0.1))
    if dropout:
        conf = dataclasses.replace(conf, layers=tuple(
            dataclasses.replace(l, dropout=dropout)
            if "transformer" in l.name else l for l in conf.layers))
    return conf


def _fit(net, x, y):
    """One step on the batch, as either package's net takes it."""
    net.fit(JaxDataSet(x, y) if "deeplearning4j_tpu." in type(net).__module__
            else DataSet(x, y))


def _leaves(net):
    return [(f"{n}/{k}", v) for n, sub in net.params_tree.items()
            for k, v in sub.items()]


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("config", ["text_generation", "modern_llm"])
def test_checkpointed_steps_match_jax_and_the_plain_steps(config, runtime):
    jconf = dataclasses.replace(_conf(config), gradient_checkpointing=True)
    jnet, ckpt = pair(jconf, runtime)
    plain = port_twin(jnet, runtime, gradient_checkpointing=False)
    assert ckpt.conf.gradient_checkpointing
    for seed in (1, 2):
        x, y = _batch(seed)
        for net in (jnet, ckpt, plain):
            _fit(net, x, y)
    want = np_tree(jnet.params_tree)
    for (name, got), (_, base) in zip(_leaves(ckpt), _leaves(plain)):
        n, k = name.split("/")
        np.testing.assert_allclose(got.numpy(), want[n][k], **TOL[config],
                                   err_msg=name)
        assert torch.equal(got, base), name


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_a_checkpointed_step_with_dropout_is_bit_equal_to_a_plain_one(
        runtime):
    jnet, ckpt = pair(dataclasses.replace(
        _conf("text_generation", dropout=0.3), gradient_checkpointing=True),
        runtime)
    plain = port_twin(jnet, runtime, gradient_checkpointing=False)
    untouched = port_twin(jnet, runtime)
    for seed in (3, 4):
        x, y = _batch(seed)
        for net in (ckpt, plain):
            _fit(net, x, y)
    assert ckpt.score_ == plain.score_
    for (name, a), (_, b) in zip(_leaves(ckpt), _leaves(plain)):
        assert torch.equal(a, b), name
    # the masks were drawn: dropout moved the loss off the no-dropout one
    x, y = _batch(3)
    assert ckpt.score(x[:1], y[:1]) != untouched.score(x[:1], y[:1])


def test_the_backward_recomputes_each_checkpointed_block(monkeypatch):
    """Two blocks: 2 block applies a plain step, 4 a checkpointed one
    (forward and recompute), as B3a's launches double on the card."""
    calls = []
    orig = TransformerEncoderBlock.apply

    def counted(self, *a, **kw):
        calls.append(self.name)
        return orig(self, *a, **kw)

    monkeypatch.setattr(TransformerEncoderBlock, "apply", counted)
    jnet, plain = pair(_conf("text_generation"))
    ckpt = port_twin(jnet, gradient_checkpointing=True)
    x, y = _batch(5)
    _fit(plain, x, y)
    assert len(calls) == 2
    calls.clear()
    _fit(ckpt, x, y)
    assert len(calls) == 4
    calls.clear()
    ckpt.output(x)
    assert len(calls) == 2


def test_k4_checkpointed_equals_k1():
    jnet, k1 = pair(dataclasses.replace(
        _conf("modern_llm", dropout=0.2), gradient_checkpointing=True))
    k4 = port_twin(jnet, gradient_checkpointing=True)
    batches = [_batch(s) for s in range(4)]
    k1.fit([DataSet(*b) for b in batches])
    k4.fit([DataSet(*b) for b in batches], steps_per_dispatch=4)
    assert k4.fit_stats["eager_steps"] == 4
    for (name, a), (_, b) in zip(_leaves(k1), _leaves(k4)):
        assert torch.equal(a, b), name
