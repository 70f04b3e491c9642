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


def _bwd_bf16_in_design_2_order(rw, p, mask, cs, gates, c0, dhs, dhT, dcT,
                                hc):
    """The bfloat16 recurrence with design 2's sums (`csrc/lstm.cu`
    `persist::lstm_bwd_persistent_bf16_kernel`): the cell as
    `lstm_bwd_plain` rounds it, dh_prev as float32 partials of column
    blocks of `hc` hidden columns (their four gate columns each) added in
    block order, rounded once to bfloat16, then the mask's pass-through
    added and rounded again. Returns (dxw, dh0, dc0)."""
    T, _, H = cs.shape
    blocks = [torch.cat([torch.arange(g * H + s, g * H + min(s + hc, H))
                         for g in range(4)]) for s in range(0, H, hc)]
    dh, dc = dhT, dcT
    dxw = [None] * T
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
        total = torch.zeros(dh.shape, dtype=torch.float32)
        for cols in blocks:
            total = total + dgates[:, cols].float() @ rw[:, cols].float().T
        dh = total.bfloat16() + pass_h
        dxw[t] = dgates
    return torch.stack(dxw), dh, dc


@pytest.mark.parametrize("hc", [8, 16, 5], ids=["hc8", "hc16", "hc5"])
def test_bf16_design_2_summation_order_holds_against_the_pallas_backward(hc):
    """The bfloat16 recurrence of design 2 sums dh_prev as column blocks'
    float32 partials in block order (`_bwd_bf16_in_design_2_order`):
    masked rows, peepholes, H 24 in column blocks of 8, 16 (a ragged last
    block) or 5, against the Pallas backward in interpret mode, within
    `bf16_check` (at this size the float32 sums in block order round to
    the same bfloat16 as the Pallas kernel's: bit-equal)."""
    T, B, H = 9, 5, 24
    jin, (dhs, dhT, dcT) = _inputs(T, B, H, seed=13)
    xw, rw, p, h0, c0, mask = jin
    hs, cs, gates, _, _ = _run_forward(*jin, interpret=True)
    want = _run_backward((rw, p, mask, hs, cs, gates, h0, c0), dhs, dhT,
                         dcT, interpret=True)
    got = _bwd_bf16_in_design_2_order(
        *[_t(a) for a in (rw, p, mask, cs, gates, c0, dhs, dhT, dcT)], hc)
    for name, g, w in zip(("dxw", "dh0", "dc0"), got, want):
        assert g.dtype == torch.bfloat16, name
        ok, err, share = lk.bf16_check(name, g, _t(w))
        assert ok, (name, err, share)


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
    """bfloat16 keeps design 1 where design 2 does not apply: a sequence
    shorter than PERSISTENT_MIN_STEPS, B2c's recurrence where no
    bfloat16 tile's grid fits (H 1024 at B 64), the weight product where
    H is no multiple of 8; each bf16 kernel refuses a design it does not
    have; float16 and mixed dtypes are refused."""
    for T, B, H in ((1, 32, 256), (4, 32, 256), (128, 64, 1024)):
        assert lk.b2c_design(T, B, H, 132, 232448, torch.bfloat16) == \
            "cluster"
    for T, B, H in ((128, 64, 512), (50, 32, 256)):
        assert lk.b2c_design(T, B, H, 132, 232448, torch.bfloat16) == \
            "persistent"
    for T, B, H in ((1, 32, 256), (7, 5, 37)):
        assert lk.b2_design(T, B, H, 132, 232448, torch.bfloat16) == \
            "cluster"
    assert lk.b2_design(128, 64, 512, 132, 232448) == "persistent"
    assert lk.b2c_weights_design(37, torch.bfloat16) == "tiled"
    assert lk.b2c_weights_design(37, torch.float32) == "pipelined"
    z = torch.zeros(4, 4)
    lk._check_cuda(dict(a=z, b=z))
    lk._check_cuda(dict(a=z.bfloat16(), b=z.bfloat16()))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lk._check_cuda(dict(a=z.half(), b=z.half()))
    with pytest.raises(TypeError, match="one dtype a call"):
        lk._check_cuda(dict(a=z.bfloat16(), b=z))
    with pytest.raises(ValueError, match="runs designs"):
        lk._bf16_design(z.bfloat16(), "wgmma", "lstm_bwd")
    with pytest.raises(ValueError, match="runs designs"):
        lk._bf16_design(z.bfloat16(), "pipelined", "lstm_bwd_weights")
    assert lk._bf16_design(z.bfloat16(), "persistent", "lstm_fwd")
    assert lk._bf16_design(z.bfloat16(), "persistent", "lstm_bwd")
    assert lk._bf16_design(z.bfloat16(), "wgmma", "lstm_bwd_weights")
    assert not lk._bf16_design(z, "persistent", "lstm_bwd")


H100 = (132, 232448)      # SMs, shared-memory bytes a block may ask for
SMALL_CARD = (64, 232448)


# (T, B, H, the forward's design on an H100, on a 64-SM card, B2c's
# recurrence's on an H100, on a 64-SM card, the weight product's design)
BF16_DESIGN_CASES = [
    (128, 64, 512, "persistent", "cluster", "persistent", "cluster",
     "wgmma"),                                           # path_l_bf16
    (50, 32, 256, "persistent", "persistent", "persistent", "persistent",
     "wgmma"),                                           # path_g's chunks
    (32, 8, 512, "persistent", "persistent", "persistent", "persistent",
     "wgmma"),                                           # lstm_parity_bf16
    (lk.PERSISTENT_MIN_STEPS, 32, 256, "persistent", "persistent",
     "persistent", "persistent", "wgmma"),
    (1, 32, 256, "cluster", "cluster", "cluster", "cluster",
     "wgmma"),                                           # rnn_time_step
    (4, 32, 256, "cluster", "cluster", "cluster", "cluster", "wgmma"),
    (7, 5, 37, "cluster", "cluster", "cluster", "cluster",
     "tiled"),                                           # H % 8 != 0
    (40, 6, 100, "persistent", "persistent", "persistent", "persistent",
     "tiled"),
    (16, 70, 256, "persistent", "cluster", "persistent", "cluster",
     "wgmma"),                                           # B % 8 != 0
    (12, 3, 8, "persistent", "persistent", "persistent", "persistent",
     "wgmma"),
    (128, 64, 1024, "cluster", "cluster", "cluster", "cluster",
     "wgmma"),                                           # no tile fits
]


@pytest.mark.parametrize("T,B,H,big,small,rec_big,rec_small,weights",
                         BF16_DESIGN_CASES,
                         ids=[f"T{c[0]}B{c[1]}H{c[2]}"
                              for c in BF16_DESIGN_CASES])
def test_bf16_design_by_shape(T, B, H, big, small, rec_big, rec_small,
                              weights):
    """Which design takes a bfloat16 call, by shape and card: the forward
    (one rule for B2a and B2b) on design 2 from PERSISTENT_MIN_STEPS
    steps where a bfloat16 tile fits (`b2_rows` with esize 2), the
    recurrence of B2c by the same rule with its own tile (`b2c_rows`
    with esize 2), the weight product on "wgmma" where H is a multiple
    of 8."""
    assert lk.b2_design(T, B, H, *H100, torch.bfloat16) == big
    assert lk.b2_design(T, B, H, *SMALL_CARD, torch.bfloat16) == small
    assert lk.b2c_design(T, B, H, *H100, torch.bfloat16) == rec_big
    assert lk.b2c_design(T, B, H, *SMALL_CARD, torch.bfloat16) == rec_small
    assert lk.b2c_weights_design(H, torch.bfloat16) == weights
    assert lk.b2c_weights_design(H) == "pipelined"


def _bf16_smem(B, H, rows):
    """The bfloat16 design 2's shared memory (`csrc/lstm.cu`
    `persist::bf16_smem_bytes`): the strip [NC][row] and the h tile
    [BR][row] in bfloat16, row = H rounded up to 16 plus 8, and the
    rounded products [BR][NC] float32."""
    nc, row = 1024 // rows, -(-H // 16) * 16 + 8
    return 2 * row * (nc + rows) + 4 * rows * nc


@pytest.mark.parametrize("B,H,rows", [
    (64, 512, 8),         # path_l_bf16: 8 x 16 blocks (float32 needs 16)
    (32, 256, 8),
    (8, 512, 8),          # lstm_parity_bf16
    (4, 1024, 16),        # 8 rows would need 284,800 bytes
    (5, 37, 8),
    (64, 1024, None),     # 256 blocks at every tile: past 132 SMs
    (128, 512, None),
])
def test_bf16_rows_follow_the_element_size(B, H, rows):
    """`b2_rows(..., esize=2)`: the smallest tile whose grid fits the
    SMs and whose bfloat16 strip, h tile and float32 products fit a
    block's shared memory; a smaller tile does not fit; at most the
    float32 tile wherever both fit."""
    assert lk.b2_rows(B, H, *H100, 2) == rows
    for r in lk.PERSISTENT_ROWS:
        fits = (-(-B // r) * -(-H // (256 // r)) <= H100[0]
                and _bf16_smem(B, H, r) <= H100[1])
        if rows is None or r < rows:
            assert not fits, r
        elif r == rows:
            assert fits
    f32 = lk.b2_rows(B, H, *H100)
    assert f32 is None or (rows is not None and rows <= f32)


def _bf16_bwd_smem(H, rows):
    """The bfloat16 recurrence's shared memory (`csrc/lstm.cu`
    `persist::bwd_bf16_smem_bytes`): the strip [HK][NC + 8] and the gate
    gradients [BR][NC + 8] in bfloat16, HK = H rounded up to 16."""
    nc = 1024 // rows
    return 2 * (nc + 8) * (-(-H // 16) * 16 + rows)


@pytest.mark.parametrize("B,H,rows", [
    (64, 512, 8),         # path_l_bf16: 8 x 16 blocks (float32 needs 16)
    (32, 256, 8),         # path_g's chunks
    (8, 512, 8),          # lstm_parity_bf16
    (70, 256, 8),         # a batch past a multiple of 8: 9 x 8 blocks
    (6, 100, 8),          # H not a multiple of 16: HK 112
    (4, 1024, 16),        # 8 rows would need 280,704 bytes
    (64, 1024, None),     # 256 blocks at every tile: past 132 SMs
    (128, 512, None),
])
def test_bf16_b2c_rows_follow_the_element_size(B, H, rows):
    """`b2c_rows(..., esize=2)`: the smallest tile whose grid fits the
    SMs and whose bfloat16 strip and gate gradients fit a block's shared
    memory; a smaller tile does not fit; at most the float32 tile
    wherever both fit."""
    assert lk.b2c_rows(B, H, *H100, 2) == rows
    for r in lk.PERSISTENT_ROWS:
        fits = (-(-B // r) * -(-H // (256 // r)) <= H100[0]
                and _bf16_bwd_smem(H, r) <= H100[1])
        if rows is None or r < rows:
            assert not fits, r
        elif r == rows:
            assert fits
    f32 = lk.b2c_rows(B, H, *H100)
    assert f32 is None or (rows is not None and rows <= f32)


@pytest.mark.parametrize("T,B,H,sms,splits", [
    (128, 64, 512, 132, 4),     # path_l_bf16: 32 tiles of dRW x 4 slices
    (50, 32, 256, 132, 6),      # 26 K tiles: 5 a slice
    (32, 8, 512, 132, 1),       # lstm_parity_bf16: 5 K tiles
    (128, 64, 512, 64, 2),
    (128, 64, 1024, 132, 1),    # 128 tiles of dRW fill the card alone
])
def test_wgmma_splits_and_slices_cover_k_once(T, B, H, sms, splits):
    """`b2c_wgmma_splits` (one block a SM, at least 4 K tiles a slice, no
    slice empty) and `b2c_wgmma_slices`: the slices cover the T·B rows of
    hprev once, in order, each cut where a K tile ends (h0's B rows first,
    then hs's in tiles of WGMMA_DEPTH)."""
    assert lk.b2c_wgmma_splits(T, B, H, sms) == splits
    tiles = -(-H // lk.WGMMA_TILE[0]) * -(-4 * H // lk.WGMMA_TILE[1])
    assert splits == 1 or tiles * splits <= sms
    slices = lk.b2c_wgmma_slices(T, B, splits)
    assert len(slices) == splits
    assert slices[0][0] == 0 and slices[-1][1] == T * B
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(k1 > k0 for k0, k1 in slices)
    ends = {min(lk.WGMMA_DEPTH * i, B) for i in range(1, B + 1)} | {
        B + lk.WGMMA_DEPTH * j for j in range(T * B)}
    assert all(k1 in ends or k1 == T * B for _, k1 in slices)


@pytest.mark.parametrize("T,B,H,splits", [(12, 4, 16, 2), (24, 3, 8, 3),
                                          (9, 70, 8, 4)],
                         ids=["T12B4", "T24B3", "T9B70"])
def test_wgmma_sliced_sum_holds_c13_against_the_pallas_backward(T, B, H,
                                                                splits):
    """The "wgmma" weight product's arithmetic (`lstm_weights_plain` with
    `slices`: each K slice summed in float32, the slices added in slice
    order, rounded once) on JAX's dxw, against the Pallas backward's
    running bfloat16 dRW in interpret mode: within `c13_bound`, and the
    slices' order parts from one float32 sum by no more than two float32
    sums' error (`weights_f32_err`) before rounding. B 70 straddles a K
    tile of 64 rows in h0."""
    jin, (dhs, dhT, dcT) = _inputs(T, B, H, seed=5)
    xw, rw, p, h0, c0, mask = jin
    hs, cs, gates, _, _ = _run_forward(*jin, interpret=True)
    want = _run_backward((rw, p, mask, hs, cs, gates, h0, c0), dhs, dhT,
                         dcT, interpret=True)
    wts = [_t(a) for a in (hs, h0, want[0], cs, c0)]
    slices = lk.b2c_wgmma_slices(T, B, splits)
    assert len(slices) == splits
    got = lk.lstm_weights_plain(*wts, slices=slices)
    once = lk.lstm_weights_plain(*wts, running=False)
    bound = lk.c13_bound(*wts)
    for name, g, w, b in zip(("dRW", "dP"), got, want[3:], bound):
        assert g.dtype == torch.bfloat16, name
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        err = (g.float() - w).abs()
        assert torch.all(err <= b), name
    assert torch.equal(got[1], once[1])     # dP does not slice
    f32 = lk.weights_f32_err(*wts)[0]
    hp = torch.cat([wts[1][None], wts[0][:-1]]).float().reshape(T * B, H)
    d = wts[2].float().reshape(T * B, 4 * H)
    sliced = sum((hp[a:b].T @ d[a:b] for a, b in slices[1:]),
                 hp[slices[0][0]:slices[0][1]].T @ d[slices[0][0]:
                                                     slices[0][1]])
    assert torch.all((sliced - hp.T @ d).abs() <= 2 * f32)
    assert torch.equal(got[0], sliced.bfloat16())


def test_bf16_design_2_counts_have_their_own_keys_and_stay_zero_on_cpu():
    """The bfloat16 design-2 launches count under keys of their own,
    beside design 1's; on the CPU (the plain versions) nothing is
    counted, at a shape where a card would run design 2."""
    assert {("lstm_fwd", "persistent_bf16"),
            ("lstm_fwd_inference", "persistent_bf16"),
            ("lstm_bwd_weights", "wgmma_bf16"),
            ("lstm_fwd", "cluster_bf16"),
            ("lstm_bwd_weights", "tiled_bf16")} <= set(lk.LAUNCHES_BY_DESIGN)
    assert ("lstm_bwd", "persistent_bf16") in lk.LAUNCHES_BY_DESIGN
    lk.LAUNCHES_BY_DESIGN[("lstm_fwd", "persistent_bf16")] = 3
    lk.LAUNCHES_BY_DESIGN[("lstm_bwd", "persistent_bf16")] = 3
    lk.LAUNCHES_BY_DESIGN[("lstm_bwd_weights", "wgmma_bf16")] = 3
    lk.reset_counts()
    jin, _ = _inputs(lk.PERSISTENT_MIN_STEPS, 3, 8)
    tin = [_t(a).requires_grad_(i < 5) for i, a in enumerate(jin)]
    hs, _, _ = lk.fused_lstm(*tin)
    torch.autograd.grad(hs.float().sum(), tin[:5])
    with torch.no_grad():
        lk.fused_lstm(*tin)
    assert set(lk.LAUNCHES.values()) == {0}
    assert set(lk.LAUNCHES_BY_DESIGN.values()) == {0}


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
