"""The bfloat16 fused LSTM of the PyTorch port against the JAX package,
on the CPU: the plain versions of B2a/B2b/B2c (`ops/lstm.py`) on
bfloat16 tensors against the Pallas kernels in interpret mode, from the
same seeded numpy inputs.

The plain versions round after every operation, as XLA evaluates the
interpreted Pallas body (sigmoid as 1 / (1 + exp(-x)), each step
rounded; dP's products summed unrounded), so every output, the
backward's dRW and dP included, equals JAX's bit for bit: no tolerance.
The CUDA kernels carry the same rounding points; they part from the
plain versions by `bf16_check` (whose limits the last test derives from
the plain version against itself), and in dRW and dP (a float32 sum
rounded once, where these keep a running bfloat16 sum) by contract C13
(`c13_bound`), exercised here on the plain arithmetic."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.lstm import _run_backward, _run_forward
from deeplearning4j_tpu_torch.ops import lstm as lk

BF = jnp.bfloat16
SHAPES = [(12, 4, 16), (5, 3, 8)]
IDS = [f"T{t}B{b}H{h}" for t, b, h in SHAPES]


def _inputs(T, B, H, seed=0, masked=True, peephole=True):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, B, 4 * H))
    rw = rng.standard_normal((H, 4 * H)) / np.sqrt(H)
    p = rng.standard_normal((3, H)) * 0.1 if peephole else np.zeros((3, H))
    h0 = rng.standard_normal((B, H)) * 0.1
    c0 = rng.standard_normal((B, H)) * 0.1
    mask = np.ones((T, B))
    if masked:
        mask[2 * T // 3:, 1] = 0          # one row ends early
    cot = [rng.standard_normal(s) for s in ((T, B, H), (B, H), (B, H))]
    return ([jnp.asarray(a, jnp.float32).astype(BF)
             for a in (xw, rw, p, h0, c0, mask)],
            [jnp.asarray(a, jnp.float32).astype(BF) for a in cot])


def _t(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


def _equal(got, want, names):
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)),
                                      err_msg=name)


@pytest.mark.parametrize("T,B,H", SHAPES, ids=IDS)
@pytest.mark.parametrize("peephole", [True, False], ids=["peep", "plain"])
def test_plain_b2a_b2b_equal_the_pallas_forward(T, B, H, peephole):
    jin, _ = _inputs(T, B, H, peephole=peephole)
    want = _run_forward(*jin, interpret=True)
    tin = [_t(a) for a in jin]
    _equal(lk.lstm_fwd_plain(*tin), want, ("hs", "cs", "gates", "hT", "cT"))
    hs, cs, gates, hT, cT = lk.lstm_fwd(*tin, with_residuals=False)
    assert cs is None and gates is None
    _equal((hs, hT, cT), (want[0], want[3], want[4]), ("hs", "hT", "cT"))


@pytest.mark.parametrize("T,B,H", SHAPES, ids=IDS)
def test_plain_b2c_equals_the_pallas_backward(T, B, H):
    jin, (dhs, dhT, dcT) = _inputs(T, B, H, seed=1)
    xw, rw, p, h0, c0, mask = jin
    hs, cs, gates, _, _ = _run_forward(*jin, interpret=True)
    want = _run_backward((rw, p, mask, hs, cs, gates, h0, c0), dhs, dhT,
                         dcT, interpret=True)
    got = lk.lstm_bwd(*[_t(a) for a in (rw, p, mask, hs, cs, gates, h0, c0,
                                        dhs, dhT, dcT)])
    _equal(got, want, ("dxw", "dh0", "dc0", "dRW", "dP"))


def _backward(T=12, B=4, H=16, seed=2):
    jin, cot = _inputs(T, B, H, seed=seed)
    tin = [_t(a) for a in jin]
    hs, cs, gates, _, _ = lk.lstm_fwd_plain(*tin)
    xw, rw, p, h0, c0, mask = tin
    out = lk.lstm_bwd_plain(rw, p, mask, hs, cs, gates, h0, c0,
                            *[_t(a) for a in cot])
    return hs, cs, h0, c0, out


def test_weights_plain_is_the_backwards_running_sum():
    hs, cs, h0, c0, (dxw, _, _, drw, dp) = _backward()
    got = lk.lstm_weights_plain(hs, h0, dxw, cs, c0)
    assert torch.equal(got[0], drw) and torch.equal(got[1], dp)
    # float32: the two orders of the sum agree to float32 rounding
    f = [a.float() for a in (hs, h0, dxw, cs, c0)]
    run = lk.lstm_weights_plain(*f[:3], *f[3:])
    once = lk.lstm_weights_plain(*f[:3], *f[3:], running=False)
    for a, b in zip(run, once):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_c13_bound_covers_a_float32_sum_rounded_once():
    """The CUDA weight product's arithmetic (float32, rounded once)
    against the running bfloat16 sum: inside `c13_bound`, and the bound
    is not vacuous (a few bfloat16 steps of the largest |dRW|)."""
    hs, cs, h0, c0, (dxw, _, _, drw, dp) = _backward(T=24, seed=3)
    once = lk.lstm_weights_plain(hs, h0, dxw, cs, c0, running=False)
    bound = lk.c13_bound(hs, h0, dxw, cs, c0)
    for name, got, want, b in zip(("dRW", "dP"), once, (drw, dp), bound):
        err = (got.float() - want.float()).abs()
        assert torch.all(err <= b), name
        assert float(err.max()) > 0, name      # the two sums do part
        assert float(b.max()) < 16 * lk.BF16_STEP * float(
            want.float().abs().max()), name


def test_bf16_atol_by_output():
    w = torch.tensor([[-3.0, 0.5]], dtype=torch.bfloat16)
    assert lk.bf16_atol("hs", w) == lk.bf16_atol("gates", w) == 2.0 ** -5
    assert lk.bf16_atol("cs", w) == 3 * 2.0 ** -5
    assert lk.bf16_atol("dxw", w) == lk.bf16_atol("dh0", w) == 3 * 2.0 ** -4
    a = torch.zeros(64, dtype=torch.bfloat16)
    b = a.clone()
    b[:3] = 2.0 ** -6           # 3 of 64 elements differ: inside
    assert lk.bf16_check("hs", b, a) == (True, 2.0 ** -6, 3 / 64)
    b[:9] = 2.0 ** -6           # 9 of 64, past the share of 2^-3
    assert not lk.bf16_check("hs", b, a)[0]
    assert lk.bf16_check("hT", b, a)[0]      # no share on the carries


def _forward(ins, product, round_each_op=True):
    """The bf16 forward written out: `product(h, rw)` the recurrent
    product rounded to bf16; with `round_each_op` False the cell runs
    in float32 and rounds only h, c and the gates it stores."""
    xw, rw, p, h, c, mask = ins
    H = h.shape[1]
    R = (lambda t: t) if round_each_op else (lambda t: t.bfloat16().float())
    if not round_each_op:
        xw, p, h, c, mask = (t.float() for t in (xw, p, h, c, mask))
    hs, gs = [], []
    for t in range(xw.shape[0]):
        z = xw[t] + product(h, rw).to(xw.dtype)
        sig = lk._sigmoid if round_each_op else torch.sigmoid
        i, f = sig(z[:, :H] + c * p[0:1]), sig(z[:, H:2 * H] + c * p[1:2])
        g = torch.tanh(z[:, 2 * H:3 * H])
        c_new = f * c + i * g
        o = sig(z[:, 3 * H:] + c_new * p[2:3])
        m = mask[t][:, None]
        h = R(m * (o * torch.tanh(c_new)) + (1.0 - m) * h)
        c = R(m * c_new + (1.0 - m) * c)
        hs.append(h)
        gs.append(R(torch.cat([i, f, g, o], dim=-1)))
    return torch.stack(hs), torch.stack(gs)


def test_plain_bf16_misses_a_step_against_itself_in_another_sum_order():
    """Why `bf16_check` allows 2^-5 and not a bfloat16 step: at
    `path_l`'s shape the plain forward with its recurrent product summed
    in float64 (another exact order), rounded once, parts from the
    plain forward (float32 sums) by more than 2^-7 in hs, as a rounding
    that lands the other way is carried on by the recurrence; yet in
    few elements. A forward that rounds only where it stores (float32
    inside) parts from it in most elements: the share test catches it."""
    g = torch.Generator().manual_seed(1)
    T, B, H = 128, 64, 512

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).bfloat16()

    ins = (rnd(T, B, 4 * H), rnd(H, 4 * H, scale=H ** -0.5),
           rnd(3, H, scale=0.5), rnd(B, H, scale=0.5), rnd(B, H, scale=0.5))
    lens = torch.randint(T // 4, T + 1, (B,), generator=g)
    ins += ((torch.arange(T)[:, None] < lens[None, :]).bfloat16(),)
    hs, _, gates, _, _ = lk.lstm_fwd_plain(*ins)
    mm = _forward(ins, lambda h, w: h @ w)
    assert torch.equal(mm[0], hs) and torch.equal(mm[1], gates)
    f64 = _forward(ins, lambda h, w: (h.double() @ w.double()))
    err = float((f64[0].float() - hs.float()).abs().max())
    assert err > lk.BF16_STEP
    assert lk.bf16_check("hs", f64[0], hs)[0]
    assert lk.bf16_check("gates", f64[1], gates)[0]
    inside = _forward(ins, lambda h, w: h.float() @ w.float(),
                      round_each_op=False)
    ok, _, share = lk.bf16_check("hs", inside[0], hs)
    assert not ok and share > 0.5


def test_bf16_runs_design_1_and_other_dtypes_are_refused():
    for T, B, H in ((128, 64, 512), (50, 32, 256), (1, 32, 256)):
        assert lk.b2_design(T, B, H, 132, 232448, torch.bfloat16) == \
            "cluster"
        assert lk.b2c_design(T, B, H, 132, 232448, torch.bfloat16) == \
            "cluster"
    assert lk.b2_design(128, 64, 512, 132, 232448) == "persistent"
    assert lk.b2c_weights_design(torch.bfloat16) == "tiled"
    assert lk.b2c_weights_design(torch.float32) == "pipelined"
    z = torch.zeros(4, 4)
    lk._check_cuda(dict(a=z, b=z))
    lk._check_cuda(dict(a=z.bfloat16(), b=z.bfloat16()))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lk._check_cuda(dict(a=z.half(), b=z.half()))
    with pytest.raises(TypeError, match="one dtype a call"):
        lk._check_cuda(dict(a=z.bfloat16(), b=z))
    with pytest.raises(ValueError, match="design 'cluster'"):
        lk._bf16_design(z.bfloat16(), "persistent", "cluster")
    assert not lk._bf16_design(z, "persistent", "cluster")


def test_bf16_counts_have_their_own_keys_and_stay_zero_on_cpu():
    assert {"lstm_fwd_bf16", "lstm_fwd_inference_bf16", "lstm_bwd_bf16",
            "lstm_bwd_weights_bf16"} <= set(lk.LAUNCHES)
    lk.reset_counts()
    jin, _ = _inputs(5, 3, 8)
    tin = [_t(a).requires_grad_(i < 5) for i, a in enumerate(jin)]
    hs, _, _ = lk.fused_lstm(*tin)
    torch.autograd.grad(hs.float().sum(), tin[:5])
    assert set(lk.LAUNCHES.values()) == {0}
    assert set(lk.LAUNCHES_BY_DESIGN.values()) == {0}
