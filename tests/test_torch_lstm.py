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


# ------------------------------------------- B2a/B2b design choice (b2_design)
H100 = (132, 232448)      # SMs, shared-memory bytes a block may ask for


@pytest.mark.parametrize("B,H,rows", [
    (64, 512, 16),        # path_l: 4 x 32 blocks of 16 rows x 16 columns
    (32, 256, 8),         # path_g: 4 x 8 blocks of 8 rows x 32 columns
    (4, 512, 16),         # lstm_parity: 8 rows would need 256 KB
    (3, 8, 8),
    (64, 1024, None),     # 256 blocks at every tile: past 132 SMs
    (128, 512, None),
])
def test_b2_rows_fit_the_sms_and_shared_memory(B, H, rows):
    """The smallest tile of `PERSISTENT_ROWS` whose grid fits one block on
    each SM and whose strip of RW beside the h tile (or the partial sums)
    fits a block's shared memory."""
    assert lk.b2_rows(B, H, *H100) == rows
    if rows is not None:
        nc = 1024 // rows
        assert -(-B // rows) * -(-H // (nc // 4)) <= H100[0]
        assert 4 * (H * nc + max(H * rows, 8 * rows * (nc + 4))) <= H100[1]


@pytest.mark.parametrize("T,B,H,want", [
    (128, 64, 512, "persistent"),     # path_l's B2a
    (200, 32, 256, "persistent"),     # path_g's output()
    (50, 32, 256, "persistent"),      # path_g's tBPTT chunks
    (lk.PERSISTENT_MIN_STEPS, 32, 256, "persistent"),
    (lk.PERSISTENT_MIN_STEPS - 1, 32, 256, "cluster"),
    (1, 32, 256, "cluster"),          # rnn_time_step
    (128, 64, 1024, "cluster"),       # no design-2 tile fits
])
def test_b2_design_by_shape(T, B, H, want):
    """One rule for B2a and B2b, from the shape and the card."""
    assert lk.b2_design(T, B, H, *H100) == want
    # a card with fewer SMs keeps design 2 only where the grid still fits
    assert lk.b2_design(T, B, H, 64, H100[1]) == (
        "cluster" if want == "cluster" or lk.b2_rows(B, H, 64, H100[1])
        is None else "persistent")


def test_lstm_launch_counts_by_design_reset_and_stay_zero_on_cpu():
    lk.LAUNCHES_BY_DESIGN[("lstm_fwd", "persistent")] = 4
    lk.LAUNCHES_BY_DESIGN[("lstm_bwd", "persistent")] = 2
    lk.LAUNCHES_BY_DESIGN[("lstm_bwd_weights", "pipelined")] = 2
    lk.reset_counts()
    assert set(lk.LAUNCHES_BY_DESIGN) == {
        (k, d) for k in ("lstm_fwd", "lstm_fwd_inference")
        for d in ("cluster", "persistent")} | {
        ("lstm_bwd", "cluster"), ("lstm_bwd", "persistent"),
        ("lstm_bwd_weights", "tiled"), ("lstm_bwd_weights", "pipelined")} | {
        ("lstm_fwd", "cluster_bf16"), ("lstm_fwd_inference", "cluster_bf16"),
        ("lstm_fwd", "persistent_bf16"),
        ("lstm_fwd_inference", "persistent_bf16"),
        ("lstm_bwd", "cluster_bf16"), ("lstm_bwd", "persistent_bf16"),
        ("lstm_bwd_weights", "tiled_bf16"),
        ("lstm_bwd_weights", "wgmma_bf16")}
    tin = _t(_inputs(masked=True), grad=True)
    hs, _, _ = lk.fused_lstm(*tin)
    torch.autograd.grad(hs.sum(), tin[:5])      # B2c's plain version
    assert set(lk.LAUNCHES_BY_DESIGN.values()) == {0}
    assert set(lk.LAUNCHES.values()) == {0}


# ------------------------------------------------ B2c design choice (b2c_*)
@pytest.mark.parametrize("B,H,rows", [
    (64, 512, 16),        # path_l: 4 x 32 blocks; 8 rows would need 294 KB
    (32, 256, 8),         # path_g's tBPTT chunks: 4 x 8 blocks
    (4, 512, 16),         # lstm_parity
    (5, 37, 8),           # H not a multiple of 4: Hp 40
    (4, 640, 16),
    (64, 1024, None),     # 256 blocks at every tile: past 132 SMs
    (128, 512, None),
])
def test_b2c_rows_fit_the_sms_and_shared_memory(B, H, rows):
    """The smallest tile of `PERSISTENT_ROWS` whose grid fits one block on
    each SM and whose transposed strip of RW, the step's gate gradients
    and (where the product splits its gate columns over Q thread groups)
    the groups' sums fit a block's shared memory."""
    assert lk.b2c_rows(B, H, *H100) == rows
    if rows is not None:
        nc, hp = 1024 // rows, -(-H // 4) * 4
        assert -(-B // rows) * -(-H // (nc // 4)) <= H100[0]
        tiles = rows // 8 * hp // 4
        q = lk._b2c_ksplit(tiles)
        # as many groups as fill the 256 threads, at most one a warp
        assert q in (1, 2, 4, 8) and (q == 1 or tiles * q <= 256)
        assert q == 8 or 2 * q * tiles > 256
        assert 4 * (nc * (hp + 4) + nc * rows
                    + (q * rows * hp if q > 1 else 0)) <= H100[1]
    # one tile smaller does not fit, where there is one
    smaller = [r for r in lk.PERSISTENT_ROWS if rows is None or r < rows]
    for r in smaller:
        nc, hp = 1024 // r, -(-H // 4) * 4
        q = lk._b2c_ksplit(r // 8 * hp // 4)
        assert (-(-B // r) * -(-H // (nc // 4)) > H100[0]
                or 4 * (nc * (hp + 4) + nc * r
                        + (q * r * hp if q > 1 else 0)) > H100[1])


def test_b2c_ksplit_keeps_the_threads_busy():
    assert [lk._b2c_ksplit(n) for n in (256, 320, 128, 64, 10, 1)] == \
        [1, 1, 2, 4, 8, 8]


@pytest.mark.parametrize("T,B,H,want", [
    (128, 64, 512, "persistent"),     # path_l
    (50, 32, 256, "persistent"),      # path_g's tBPTT chunks
    (32, 4, 512, "persistent"),       # lstm_parity
    (lk.PERSISTENT_MIN_STEPS, 32, 256, "persistent"),
    (lk.PERSISTENT_MIN_STEPS - 1, 32, 256, "cluster"),
    (128, 64, 1024, "cluster"),       # no design-2 grid fits
    (128, 128, 512, "cluster"),
])
def test_b2c_design_by_shape(T, B, H, want):
    """B2c's recurrence by `b2_design`'s rule over `b2c_rows`."""
    assert lk.b2c_design(T, B, H, *H100) == want
    # a card with fewer SMs keeps design 2 only where the grid still fits:
    # path_l's 128 blocks do not fit 64
    small = lk.b2c_design(T, B, H, 64, H100[1])
    assert small == ("cluster" if want == "cluster" or lk.b2c_rows(
        B, H, 64, H100[1]) is None else "persistent")
    if (B, H) == (64, 512):
        assert small == "cluster"


@pytest.mark.parametrize("T,B,H,sms,want", [
    (128, 64, 512, 132, 4),     # path_l: 64 tiles x 4 slices = 256 blocks
    (50, 32, 256, 132, 6),      # path_g's chunks: 1600 rows of K
    (32, 4, 512, 132, 1),       # lstm_parity: 128 rows of K
    (128, 64, 512, 64, 2),
    (128, 64, 1024, 132, 1),    # 256 tiles fill the card alone
])
def test_b2c_splits_fill_two_blocks_an_sm(T, B, H, sms, want):
    assert lk.b2c_splits(T, B, H, sms) == want
    tiles = -(-H // lk.WEIGHT_TILE) * -(-4 * H // lk.WEIGHT_TILE)
    assert want == 1 or (tiles * want <= 2 * sms and T * B // want >= 256)


def _bwd_in_design_2_order(rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT,
                           dcT, hc, br, splits):
    """The backward with design 2's sums (`csrc/lstm.cu`): dh_prev as the
    partials of column blocks of `hc` hidden columns (their four gate
    columns each) added in block order, then the mask's pass-through; dP
    summed over time for each (row, column), then over the rows of each
    batch tile of `br` in row order, then over the tiles in order; dRW as
    `splits` slices of the T·B rows, added in slice order."""
    T, B, H = hs.shape
    dh, dc = dhT, dcT
    dxw = [None] * T
    dpa = torch.zeros(3, B, H, dtype=hs.dtype)
    blocks = [torch.cat([torch.arange(g * H + s, g * H + min(s + hc, H))
                         for g in range(4)]) for s in range(0, H, hc)]
    for t in range(T - 1, -1, -1):
        gt = gates[t]
        i, f, g, o = (gt[:, :H], gt[:, H:2 * H], gt[:, 2 * H:3 * H],
                      gt[:, 3 * H:])
        c_t = cs[t]
        c_prev = c0 if t == 0 else cs[t - 1]
        m = mask[t][:, None]
        dh_in = dhs[t] + dh
        dh_t = m * dh_in
        pass_h = (1.0 - m) * dh_in
        tanh_c = torch.tanh(c_t)
        do_pre = dh_t * tanh_c * o * (1.0 - o)
        dc_new = (m * dc + dh_t * o * (1.0 - tanh_c * tanh_c)
                  + do_pre * p[2:3])
        di_pre = dc_new * g * i * (1.0 - i)
        df_pre = dc_new * c_prev * f * (1.0 - f)
        dg_pre = dc_new * i * (1.0 - g * g)
        dc = (dc_new * f + (1.0 - m) * dc + di_pre * p[0:1]
              + df_pre * p[1:2])
        dgates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1)
        total = torch.zeros_like(dh)
        for cols in blocks:
            total = total + dgates[:, cols] @ rw[:, cols].T
        dh = total + pass_h
        dxw[t] = dgates
        dpa = dpa + torch.stack([di_pre * c_prev, df_pre * c_prev,
                                 do_pre * c_t])
    dp = torch.zeros_like(p)
    for b0 in range(0, B, br):
        tile = torch.zeros_like(p)
        for b in range(b0, min(b0 + br, B)):
            tile = tile + dpa[:, b]
        dp = dp + tile
    dxw = torch.stack(dxw)
    hprev = torch.cat([h0[None], hs[:-1]]).reshape(T * B, H)
    flat = dxw.reshape(T * B, 4 * H)
    chunk = -(-T * B // splits)
    drw = torch.zeros_like(rw)
    for k0 in range(0, T * B, chunk):
        drw = drw + hprev[k0:k0 + chunk].T @ flat[k0:k0 + chunk]
    return dxw, dh, dc, drw, dp


@pytest.mark.parametrize("hc,br,splits", [(8, 2, 1), (16, 4, 3), (5, 8, 2)],
                         ids=["hc8", "hc16", "hc5"])
def test_design_2_summation_order_matches_the_pallas_backward(hc, br,
                                                              splits):
    """Design 2 of B2c sums dh_prev, dP and dRW in another order than the
    plain version (`_bwd_in_design_2_order`): masked rows, peepholes, H
    24 in column blocks of 8, 16 (a ragged last block) or 5, batch tiles
    that do not divide B, against the VJP of the JAX package's
    `fused_lstm` with its Pallas backward in interpret mode, within the
    1e-4 relative + 1e-6 absolute of
    `test_autograd_function_matches_jax_grad`."""
    T, B, H = 7, 5, 24
    arrs = _inputs(T, B, H, peephole=True, masked=True, seed=11)
    rng = np.random.default_rng(12)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((T, B, H), (B, H), (B, H))]
    mask = jnp.asarray(arrs[5])
    _, vjp = jax.vjp(lambda *a: jax_lstm(*a, mask, True),
                     *[jnp.asarray(a) for a in arrs[:5]])
    want = vjp(tuple(jnp.asarray(c) for c in cts))   # dxw drw dp dh0 dc0
    xw, rw, p, h0, c0, m = _t(arrs)
    hs, cs, gates, _, _ = lk.lstm_fwd_plain(xw, rw, p, h0, c0, m)
    dhs, dhT, dcT = (torch.from_numpy(c) for c in cts)
    dxw, dh0, dc0, drw, dp = _bwd_in_design_2_order(
        rw, p, m, hs, cs, gates, h0, c0, dhs, dhT, dcT, hc, br, splits)
    for name, a, b in zip(NAMES, (dxw, drw, dp, dh0, dc0), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=f"d{name}")
    # and the order does differ from the plain version's somewhere
    ref = lk.lstm_bwd_plain(rw, p, m, hs, cs, gates, h0, c0, dhs, dhT, dcT)
    assert any(not torch.equal(a, b) for a, b in
               zip((dxw, dh0, dc0, drw, dp), ref))
