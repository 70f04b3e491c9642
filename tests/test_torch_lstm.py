"""The fused-LSTM op of the PyTorch port against the JAX package, on the
CPU: the plain versions of kernels B2a/B2b (forward) and B2c (backward)
in `deeplearning4j_tpu_torch/ops/lstm.py` against the Pallas kernels of
`deeplearning4j_tpu/ops/lstm.py` run in interpret mode, from the same
seeded numpy inputs.

Tolerances: forward outputs and residuals within 1e-5 (float32 sums of
H products in another order); the five gradients within 1e-4 relative
+ 1e-6 absolute, as the JAX package's own test holds its kernel to its
scan. The hand-written plain backward equals autograd through the plain
forward to float64 rounding."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops.lstm import _run_forward, fused_lstm as jax_lstm
from deeplearning4j_tpu_torch.ops import lstm as lk
from deeplearning4j_tpu_torch.ops.kernel_defaults import lstm_policy

NAMES = ("xw", "rw", "p", "h0", "c0")
SHAPES = [(6, 4, 8), (7, 3, 24), (1, 3, 8)]
SHAPE_IDS = [f"T{t}B{b}H{h}" for t, b, h in SHAPES]


def _inputs(T=6, B=4, H=8, peephole=True, masked=False, seed=0,
            dtype=np.float32):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, B, 4 * H))
    rw = rng.standard_normal((H, 4 * H)) / np.sqrt(H)
    p = rng.standard_normal((3, H)) * 0.1 if peephole else np.zeros((3, H))
    h0 = rng.standard_normal((B, H)) * 0.1
    c0 = rng.standard_normal((B, H)) * 0.1
    mask = np.ones((T, B))
    if masked and T > 1:
        mask[T // 2:, 1] = 0          # sequence 1 ends half way
        mask[T - 1:, 2] = 0
    return tuple(a.astype(dtype) for a in (xw, rw, p, h0, c0, mask))


def _t(arrs, grad=False):
    out = [torch.from_numpy(a.copy()) for a in arrs]
    if grad:
        out = [t.requires_grad_() for t in out[:5]] + out[5:]
    return out


@pytest.mark.parametrize("T,B,H", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_plain_forward_matches_the_pallas_kernels(T, B, H, masked, peephole):
    arrs = _inputs(T, B, H, peephole, masked)
    jin = [jnp.asarray(a) for a in arrs]
    want = _run_forward(*jin, interpret=True)           # hs cs gates hT cT
    want_inf = jax_lstm(*jin, True)                     # hs hT cT
    got = lk.lstm_fwd(*_t(arrs), with_residuals=True)
    got_inf = lk.lstm_fwd(*_t(arrs), with_residuals=False)
    for name, a, b in zip(("hs", "cs", "gates", "hT", "cT"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert got_inf[1] is None and got_inf[2] is None
    for a, b in zip((got_inf[0], got_inf[3], got_inf[4]), want_inf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # the carries out are the masked carries of the last step
    assert torch.equal(got[3], got[0][-1]) and torch.equal(got[4], got[1][-1])


@pytest.mark.parametrize("T,B,H", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_autograd_function_matches_jax_grad(T, B, H, masked, peephole):
    arrs = _inputs(T, B, H, peephole, masked, seed=1)
    tgt = np.random.default_rng(2).standard_normal((T, B, H)).astype(
        np.float32)
    mask = jnp.asarray(arrs[5])

    def jloss(xw, rw, p, h0, c0):
        hs, hT, cT = jax_lstm(xw, rw, p, h0, c0, mask, True)
        return (jnp.mean((hs - jnp.asarray(tgt)) ** 2) + jnp.sum(hT * 0.1)
                + jnp.sum(cT * 0.05))

    want_l, want = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in arrs[:5]])
    tin = _t(arrs, grad=True)
    hs, hT, cT = lk.fused_lstm(*tin)
    loss = (((hs - torch.from_numpy(tgt)) ** 2).mean() + (hT * 0.1).sum()
            + (cT * 0.05).sum())
    got = torch.autograd.grad(loss, tin[:5])
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=f"d{name}")


@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_plain_backward_matches_autograd_of_plain_forward(masked, peephole):
    arrs = _inputs(7, 4, 24, peephole, masked, seed=3, dtype=np.float64)
    rng = np.random.default_rng(4)
    dhs, dhT, dcT = (torch.from_numpy(rng.standard_normal(s))
                     for s in ((7, 4, 24), (4, 24), (4, 24)))
    tin = _t(arrs, grad=True)
    hs, cs, gates, hT, cT = lk.lstm_fwd_plain(*tin)
    want = torch.autograd.grad(
        (hs * dhs).sum() + (hT * dhT).sum() + (cT * dcT).sum(), tin[:5])
    xw, rw, p, h0, c0, mask = _t(arrs)
    dxw, dh0, dc0, drw, dp = lk.lstm_bwd_plain(
        rw, p, mask, hs.detach(), cs.detach(), gates.detach(), h0, c0, dhs,
        dhT, dcT)
    for name, a, b in zip(NAMES, (dxw, drw, dp, dh0, dc0), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=f"d{name}")


def test_zero_peepholes_are_the_peephole_free_lstm_bit_for_bit():
    arrs = _inputs(6, 4, 8, peephole=False, masked=True, seed=5)
    xw, rw, p, h0, c0, mask = _t(arrs)
    hs, _, _, hT, cT = lk.lstm_fwd_plain(xw, rw, p, h0, c0, mask)
    h, c, want = h0, c0, []
    for t in range(6):                   # the cell with no peephole terms
        z = xw[t] + h @ rw
        # contiguous, as the sums with the peephole terms are: a strided
        # view may take another (scalar) path through sigmoid
        i, f, g, o = (a.contiguous() if n != 2 else a
                      for n, a in enumerate(torch.chunk(z, 4, dim=-1)))
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t][:, None]
        h, c = m * h_new + (1 - m) * h, m * c_new + (1 - m) * c
        want.append(h)
    assert torch.equal(hs, torch.stack(want))
    assert torch.equal(hT, h) and torch.equal(cT, c)


def test_inference_kernel_without_grad_training_kernel_with(monkeypatch):
    """B2b when grad is disabled or no input wants one, B2a otherwise,
    seen through which plain version the CPU wrapper calls."""
    calls = []
    real = lk.lstm_fwd_plain

    def spy(*a, **kw):
        calls.append(a[6] if len(a) > 6 else kw.get("with_residuals", True))
        return real(*a, **kw)

    monkeypatch.setattr(lk, "lstm_fwd_plain", spy)
    arrs = _inputs(masked=True)
    lk.fused_lstm(*_t(arrs))
    with torch.no_grad():
        lk.fused_lstm(*_t(arrs, grad=True))
    assert calls == [False, False]
    hs, hT, _ = lk.fused_lstm(*_t(arrs, grad=True))
    assert calls == [False, False, True]
    assert hs.requires_grad and hT.requires_grad
    assert sum(lk.LAUNCHES.values()) == 0        # nothing launched on a CPU


def test_unused_carry_outputs_backpropagate_as_zeros():
    arrs = _inputs(masked=True, seed=6)
    tin = _t(arrs, grad=True)
    hs, _, _ = lk.fused_lstm(*tin)
    got = torch.autograd.grad(hs.sum(), tin[:5])
    ref_in = _t(arrs, grad=True)
    want = torch.autograd.grad(lk.lstm_fwd_plain(*ref_in)[0].sum(),
                               ref_in[:5])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_wrapper_takes_a_transposed_xw_and_refuses_wrong_shapes():
    arrs = _inputs()
    xw, rw, p, h0, c0, mask = _t(arrs)
    strided = xw.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    a = lk.fused_lstm(strided, rw, p, h0, c0, mask)[0]
    assert torch.equal(a, lk.fused_lstm(xw, rw, p, h0, c0, mask)[0])
    with pytest.raises(ValueError, match="rw"):
        lk.lstm_fwd(xw, rw[:, :-4], p, h0, c0, mask)
    with pytest.raises(ValueError, match="mask"):
        lk.lstm_fwd(xw, rw, p, h0, c0, mask[:-1])
    with pytest.raises(ValueError, match="xw"):
        lk.lstm_fwd(xw[:, :, :-1], rw, p, h0, c0, mask)


@pytest.mark.parametrize("gate,act,fused,device,kind", [
    ("sigmoid", "tanh", None, "cpu", "fused"),
    ("sigmoid", "tanh", True, "cuda", "fused"),
    ("sigmoid", "tanh", False, "cuda", "loop"),
    ("hardsigmoid", "tanh", None, "cuda", "loop"),
    ("sigmoid", None, None, "cuda", "loop"),          # None is identity
    ("sigmoid", "softsign", None, "cpu", "loop")])
def test_lstm_policy(gate, act, fused, device, kind):
    from deeplearning4j_tpu_torch.observe import get_registry

    impl = kind if (device == "cuda" or kind == "loop") else "plain"
    counter = get_registry().counter("kernel_dispatch_total", op="lstm",
                                     impl=impl)
    before = counter.value
    assert lstm_policy(gate, act, fused=fused, device=device,
                       hidden=16).kind == kind
    assert counter.value == before + 1
    assert lk.fused_lstm_available(gate, act) == (kind == "fused"
                                                  or fused is False)


def test_lstm_policy_refusals():
    with pytest.raises(ValueError, match="fused=True requires"):
        lstm_policy("sigmoid", "relu", fused=True, device="cpu")
    # on the card a hidden size past the kernels' tile raises; the CPU's
    # plain versions take any size
    with pytest.raises(ValueError, match=f"hidden size {lk.MAX_HIDDEN + 1}"):
        lstm_policy("sigmoid", "tanh", device="cuda",
                    hidden=lk.MAX_HIDDEN + 1)
    assert lstm_policy("sigmoid", "tanh", device="cpu",
                       hidden=lk.MAX_HIDDEN + 1).kind == "fused"
