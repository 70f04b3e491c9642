"""The plain versions of the port's flash-attention kernels (B3a forward,
B3b/B3c backward) and its `autograd.Function` against the JAX package's
Pallas kernels, run in interpret mode on the CPU, from the same seeded
numpy inputs. Tolerance 1e-5 (absolute and relative) in float32: both
sides compute in float32 and differ only in summation order, over at
most 24 keys."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops.attention import (
    _run_flash, _run_flash_bwd, flash_attention as jax_flash,
)
from deeplearning4j_tpu_torch.ops import attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)
# (Tq, Tk, causal); Pallas blocks of 8 need lengths that 8 divides
SHAPES = [(16, 16, True), (16, 16, False), (16, 24, False)]


def _inputs(tq, tk, seed, bh=3, d=8):
    rng = np.random.default_rng(seed)
    mk = lambda t: rng.standard_normal((bh, t, d)).astype(np.float32)  # noqa
    return mk(tq), mk(tk), mk(tk), mk(tq)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("tq,tk,causal", SHAPES)
def test_plain_forward_matches_pallas(tq, tk, causal):
    q, k, v, _ = _inputs(tq, tk, tq + tk)
    scale = 8 ** -0.5
    want_o, want_lse = _run_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, block_q=8, block_k=8, interpret=True, with_lse=True)
    o, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    # the wrapper on CPU tensors is the plain version, lse on request
    o2, none = fa.flash_attention_fwd(_t(q), _t(k), _t(v), causal,
                                      with_lse=False)
    assert none is None and torch.equal(o2, o)


@pytest.mark.parametrize("tq,tk,causal", SHAPES)
def test_plain_backward_matches_pallas(tq, tk, causal):
    q, k, v, do = _inputs(tq, tk, 3 * tq + tk)
    scale = 8 ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = _run_flash(jq, jk, jv, causal=causal, scale=scale, block_q=8,
                        block_k=8, interpret=True, with_lse=True)
    want = _run_flash_bwd(jq, jk, jv, o, lse, jdo, causal=causal,
                          scale=scale, block_q=8, block_k=8,
                          interpret=True)
    got = fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse),
                                 _t(do), causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad_of_pallas_flash(causal):
    """[B, T, H, D] layout, as the attention layer calls it: the port's
    gradients through `flash_attention` against `jax.grad` through the
    Pallas forward and backward."""
    rng = np.random.default_rng(11)
    q, k, v, w = (rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
                  for _ in range(4))

    def jloss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, causal, None, 8, 8, True, "pallas")
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal)
    got = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


def test_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 6, 2, 4, generator=g, dtype=torch.float64)
               .requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, True), (q, k, v))
    kx, vx = (torch.randn(2, 9, 2, 4, generator=g, dtype=torch.float64)
              .requires_grad_() for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, False), (q, kx, vx))


def test_no_lse_saved_without_grad():
    """Inference (`output()`) asks the forward for no lse residual."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 5, 2, 4, generator=g)
    with torch.no_grad():
        o = fa.flash_attention(q, q, q, True)
    assert o.shape == q.shape and o.grad_fn is None


def test_wrappers_refuse_bad_shapes():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention_fwd(x, torch.zeros(2, 5, 8), torch.zeros(2, 5, 8),
                               True)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(x, torch.zeros(3, 4, 8), torch.zeros(3, 4, 8),
                               False)
