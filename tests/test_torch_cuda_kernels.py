"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the decode kernels B5 and B6 (native, and their int8/e4m3
scale-row variants B5q and B6q), the banded attention B4, the
flash-attention forward B3a and backward B3b/B3c, the fused Adam B1a and
Nesterovs B1b, the fused LSTM forward B2a/B2b and backward B2c, and the
conv+BN statistics kernels B7a/B7b. These tests import only torch,
so they run on a machine with a card and no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Where there is no card they skip (the kernels are CUDA C++ with no CPU
or interpret mode; their plain versions are held against the JAX
package in `tests/test_torch_decode_attention.py`,
`test_torch_kv_quant.py`, `test_torch_banded_attention.py`,
`test_torch_flash_attention.py`, `test_torch_fused_update.py`,
`test_torch_lstm.py` and `test_torch_conv_fused.py`).
Tolerances, in the working dtype: 2e-5 absolute in float32 on attention
outputs and lse, 1e-4 of the reference's largest magnitude on attention
gradients (sums of up to T products taken in another order); in
bfloat16 one bf16 step of the reference (2**-7 of its value, plus 1e-5),
since the kernel and the plain version both compute in float32 and
round once. The fused Adam kernel rounds every operation as the plain
version's elementwise ops do, so it is held to 2**-22 relative (two
float32 ulps) and, in bfloat16, one bf16 step; so is the fused Nesterovs
kernel. The LSTM kernels sum H products a step in another order than the
plain version's matmul, and the difference is carried through T steps:
1e-4 absolute on hs and the gates (which lie in [-1, 1]), 1e-4 of the
reference's largest magnitude on the unbounded cell states (at least 1)
and on every gradient. B7a/B7b, in both designs (bfloat16 on the tensor
cores, float32 FMA): y within 2e-5 of its largest magnitude in float32
or one bf16 step; the statistics, from the float32 accumulator in both
dtypes, within 1e-5 of Σ|y| and of Σy²."""

import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as fa
from deeplearning4j_tpu_torch.ops import banded_attention as ba
from deeplearning4j_tpu_torch.ops import conv_fused as cfk
from deeplearning4j_tpu_torch.ops import fused_update as fu
from deeplearning4j_tpu_torch.ops import lstm as lk
from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv

MODES = [("linear", None, False), ("window", 5, False),
         ("rolling", 6, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode kernels are CUDA C++ "
                    "with no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol",
                         [(torch.float32, 2e-5, 0.0),
                          (torch.bfloat16, 1e-5, 2.0 ** -7)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode,window,rolling", MODES,
                         ids=[m[0] for m in MODES])
def test_cuda_b5_matches_plain(cuda_device, mode, window, rolling, dtype,
                               atol, rtol):
    g = torch.Generator().manual_seed(3)
    S, L, H, Hkv, Dh = 5, 37, 8, 2, 64          # ragged last tile
    q = torch.randn(S, H, Dh, generator=g).to(cuda_device, dtype)
    k = torch.randn(S, L, Hkv, Dh, generator=g).to(cuda_device, dtype)
    v = torch.randn(S, L, Hkv, Dh, generator=g).to(cuda_device, dtype)
    qpos = torch.tensor([0, 4, 36, 37, 100] if rolling else
                        [0, 4, 20, 30, 36], dtype=torch.int32,
                        device=cuda_device)
    before = ba.LAUNCHES["banded_decode_attention"]
    out = ba.banded_decode_attention(q, k, v, qpos, qpos, window=window,
                                     rolling=rolling)
    ref = ba.decode_attention_plain(q, k, v, qpos, qpos, window=window,
                                    rolling=rolling)
    torch.cuda.synchronize()
    assert ba.LAUNCHES["banded_decode_attention"] == before + 1
    ref = ref.float()
    assert ((out.float() - ref).abs() <= atol + rtol * ref.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("page_len", [8, 16, 128])
def test_cuda_b6_matches_plain(cuda_device, page_len):
    g = torch.Generator().manual_seed(4)
    S, NP, H, Hkv, Dh = 4, 256 // page_len, 8, 8, 64
    P = S * NP
    q = torch.randn(S, H, Dh, generator=g).to(cuda_device)
    ck = torch.randn(P, page_len, Hkv, Dh, generator=g).to(cuda_device)
    cv = torch.randn(P, page_len, Hkv, Dh, generator=g).to(cuda_device)
    pt = torch.randperm(P, generator=g).reshape(S, NP)
    pt[1, :2] = pt[0, :2]
    pt = pt.to(cuda_device, torch.int32)
    qpos = torch.tensor([0, 100, 200, 255], dtype=torch.int32,
                        device=cuda_device)
    out = ba.paged_decode_attention(q, ck, cv, pt, qpos)
    ref = ba.paged_decode_attention_plain(q, ck, cv, pt, qpos)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,dh", [(8, 1, 64), (4, 4, 32), (8, 2, 80),
                                      (2, 2, 128)])
def test_cuda_b5_group_and_head_dim_shapes(cuda_device, h, hkv, dh):
    """GQA groups up to the register tile's 8 and head dims that are not
    a multiple of the warp width."""
    g = torch.Generator().manual_seed(h * 1000 + dh)
    S, L = 3, 70
    q = torch.randn(S, h, dh, generator=g).to(cuda_device)
    k = torch.randn(S, L, hkv, dh, generator=g).to(cuda_device)
    v = torch.randn(S, L, hkv, dh, generator=g).to(cuda_device)
    qpos = torch.tensor([1, 33, 69], dtype=torch.int32, device=cuda_device)
    out = ba.banded_decode_attention(q, k, v, qpos, qpos, window=40)
    ref = ba.decode_attention_plain(q, k, v, qpos, qpos, window=40)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_cuda_nan_query_and_empty_rows(cuda_device):
    """A NaN query comes out NaN; a lane with no visible key (an inactive
    lane on the ring: end = qpos - 1 before anything was written) comes
    out as zeros, not NaN."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn(3, 8, 64, generator=g).to(cuda_device)
    k = torch.randn(3, 40, 2, 64, generator=g).to(cuda_device)
    q[1] = float("nan")
    qpos = torch.tensor([5, 7, 0], dtype=torch.int32, device=cuda_device)
    end = torch.tensor([5, 7, -1], dtype=torch.int32, device=cuda_device)
    out = ba.banded_decode_attention(q, k, k, qpos, end, window=8,
                                     rolling=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all()
    assert torch.isnan(out[1]).all()
    assert torch.equal(out[2], torch.zeros_like(out[2]))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_shapes_past_the_register_tile(cuda_device):
    q = torch.zeros(2, 16, 64, device=cuda_device)
    k = torch.zeros(2, 8, 1, 64, device=cuda_device)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ba.banded_decode_attention(q, k, k, pos, pos)


# ------------------------------------------------- flash attention (B3)
FLASH_CASES = [
    # (BH, Tq, Tk, Dh, causal, dtype)
    (3, 1000, 1000, 64, True, torch.float32),       # ragged tail tiles
    (2, 130, 77, 64, False, torch.float32),         # Tq != Tk
    (2, 256, 256, 32, True, torch.float32),
    (2, 200, 200, 128, True, torch.float32),
    (2, 100, 100, 48, True, torch.float32),         # Dh inside the 64 tile
    (2, 300, 300, 64, True, torch.bfloat16),
]


def _flash_inputs(bh, tq, tk, dh, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    mk = lambda t: torch.randn(bh, t, dh, generator=g).to(device, dtype)  # noqa
    return mk(tq), mk(tk), mk(tk), mk(tq)


def _close(got, ref, dtype, atol):
    """float32: within `atol`; bfloat16: within `atol` plus one bf16 step
    of the reference (the float32 results may straddle a rounding
    boundary)."""
    got, ref = got.float(), ref.float()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,dh,causal,dtype", FLASH_CASES)
def test_cuda_b3a_matches_plain(cuda_device, bh, tq, tk, dh, causal, dtype):
    q, k, v, _ = _flash_inputs(bh, tq, tk, dh, dtype, cuda_device, tq + dh)
    before = fa.LAUNCHES["flash_attention_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    assert _close(o, o_ref, dtype, 2e-5)
    assert (lse - lse_ref).abs().max().item() <= 2e-5
    o2, none = fa.flash_attention_fwd(q, k, v, causal, with_lse=False)
    assert none is None and torch.equal(o2, o)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,dh,causal,dtype", FLASH_CASES)
def test_cuda_b3b_b3c_match_plain(cuda_device, bh, tq, tk, dh, causal,
                                  dtype):
    q, k, v, do = _flash_inputs(bh, tq, tk, dh, dtype, cuda_device, tk + 7)
    o, lse = fa.flash_attention_plain(q, k, v, causal)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for g_, r_ in zip(got, ref):
        assert _close(g_, r_, dtype, 1e-4 * r_.float().abs().max().item())


@pytest.mark.cuda
def test_cuda_flash_autograd_matches_dense(cuda_device):
    """The autograd Function on the card against autograd through a
    dense float32 attention, [B, T, H, D] layout."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 150, 4, 64, generator=g).to(cuda_device)
               .requires_grad_() for _ in range(3))
    o = fa.flash_attention(q, k, v, causal=True)
    w = torch.randn(o.shape, generator=g).to(cuda_device)
    grads = torch.autograd.grad((o * w).sum(), (q, k, v))
    qd, kd, vd = (t.detach().clone().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / 8.0
    s = s.masked_fill(~torch.ones(150, 150, dtype=torch.bool,
                                  device=cuda_device).tril(), -1e30)
    od = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)
    ref = torch.autograd.grad((od * w).sum(), (qd, kd, vd))
    torch.cuda.synchronize()
    assert (o - od).abs().max().item() <= 2e-5
    for a, b in zip(grads, ref):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


# ---------------------------------------------------- fused Adam (B1a)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("step", [1, 1000])
def test_cuda_b1a_matches_plain(cuda_device, dtype, step):
    g = torch.Generator().manual_seed(step)
    sizes = [1, 127, 4097, (1 << 20) + 3, 3 * fu.CHUNK]
    b1, b2, eps = 0.8, 0.99, 1e-6
    t = step + 1
    lrbc = torch.tensor(1e-3 * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t),
                        dtype=torch.float32, device=cuda_device)

    def leaf(n):
        return [torch.randn(n, generator=g).to(cuda_device, dtype)
                for _ in range(2)] + [
            (0.1 * torch.randn(n, generator=g)).to(cuda_device, dtype),
            torch.rand(n, generator=g).to(cuda_device, dtype)]

    leaves = [leaf(n) for n in sizes]
    ref = [fu.adam_update_plain(p, gr, m, v, lrbc, beta1=b1, beta2=b2,
                                eps=eps) for p, gr, m, v in leaves]
    before = fu.LAUNCHES["adam_update"]
    fu.adam_update(*zip(*leaves), lrbc, beta1=b1, beta2=b2, eps=eps)
    torch.cuda.synchronize()
    assert fu.LAUNCHES["adam_update"] == before + 1
    for (p, _, m, v), r in zip(leaves, ref):
        for got, want in zip((p, m, v), r):
            got, want = got.float(), want.float()
            tol = (2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22)
            assert ((got - want).abs() <= 1e-30 + tol * want.abs()).all()


@pytest.mark.cuda
def test_cuda_b1a_refuses_mixed_dtypes(cuda_device):
    p = torch.zeros(8, device=cuda_device)
    h = torch.zeros(8, device=cuda_device, dtype=torch.bfloat16)
    lr = torch.ones((), device=cuda_device)
    with pytest.raises(TypeError):
        fu.adam_update([p], [h], [p.clone()], [p.clone()], lr)


# ------------------------------------------------ fused Nesterovs (B1b)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_b1b_matches_plain(cuda_device, dtype):
    g = torch.Generator().manual_seed(11)
    sizes = [1, 127, 4097, (1 << 20) + 3, 3 * fu.CHUNK]
    lr = torch.tensor(0.01, dtype=torch.float32, device=cuda_device)

    def leaf(n):
        return [torch.randn(n, generator=g).to(cuda_device, dtype)
                for _ in range(2)] + [
            (0.1 * torch.randn(n, generator=g)).to(cuda_device, dtype)]

    leaves = [leaf(n) for n in sizes]
    ref = [fu.nesterov_update_plain(p, gr, v, lr, momentum=0.8)
           for p, gr, v in leaves]
    before = fu.LAUNCHES["nesterov_update"]
    fu.nesterov_update(*zip(*leaves), lr, momentum=0.8)
    torch.cuda.synchronize()
    assert fu.LAUNCHES["nesterov_update"] == before + 1
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    for (p, _, v), r in zip(leaves, ref):
        for got, want in zip((p, v), r):
            got, want = got.float(), want.float()
            assert ((got - want).abs() <= 1e-30 + tol * want.abs()).all()


@pytest.mark.cuda
def test_cuda_b1b_refuses_a_host_learning_rate(cuda_device):
    p = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError):
        fu.nesterov_update([p], [p.clone()], [p.clone()], 0.01)


# ------------------------------------------------- fused LSTM (B2a-c)
def _lstm_inputs(dev, T, B, H, peephole, masked, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)

    xw = rnd(T, B, 4 * H)
    rw = rnd(H, 4 * H, scale=H ** -0.5)
    p = rnd(3, H, scale=0.5) if peephole else torch.zeros(3, H, device=dev)
    h0, c0 = rnd(B, H, scale=0.5), rnd(B, H, scale=0.5)
    if masked:
        lens = torch.randint(max(1, T // 4), T + 1, (B,), generator=g)
        mask = (torch.arange(T)[:, None] < lens[None, :]).float().to(dev)
    else:
        mask = torch.ones(T, B, device=dev)
    return xw, rw, p, h0, c0, mask


# H 37 and 10 are not multiples of 4: the kernels' 4-byte copy path
LSTM_SHAPES = [(1, 32, 256), (12, 3, 8), (9, 5, 24), (40, 6, 100),
               (16, 4, 640), (7, 9, 37), (5, 17, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES,
                         ids=[f"T{t}B{b}H{h}" for t, b, h in LSTM_SHAPES])
def test_cuda_b2ab_match_plain(cuda_device, T, B, H, masked, peephole):
    ins = _lstm_inputs(cuda_device, T, B, H, peephole, masked)
    before = dict(lk.LAUNCHES)
    hs, cs, gates, hT, cT = lk.lstm_fwd(*ins, with_residuals=True)
    hs_i, no_cs, no_g, hT_i, cT_i = lk.lstm_fwd(*ins, with_residuals=False)
    ref = lk.lstm_fwd_plain(*ins, with_residuals=True)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["lstm_fwd"] == before["lstm_fwd"] + 1
    assert lk.LAUNCHES["lstm_fwd_inference"] == \
        before["lstm_fwd_inference"] + 1
    assert no_cs is None and no_g is None
    for name, got, want in zip(("hs", "cs", "gates", "hT", "cT"),
                               (hs, cs, gates, hT, cT), ref):
        tol = 1e-4 * max(1.0, want.abs().max().item()) \
            if name in ("cs", "cT") else 1e-4
        assert (got - want).abs().max().item() <= tol, name
    # the two forward kernels run the same arithmetic
    assert torch.equal(hs, hs_i) and torch.equal(hT, hT_i) \
        and torch.equal(cT, cT_i)
    # the carries out are the masked carries of the last step
    assert torch.equal(hT, hs[-1]) and torch.equal(cT, cs[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES[1:],
                         ids=[f"T{t}B{b}H{h}" for t, b, h in LSTM_SHAPES[1:]])
def test_cuda_b2c_matches_plain(cuda_device, T, B, H, masked, peephole):
    xw, rw, p, h0, c0, mask = _lstm_inputs(cuda_device, T, B, H, peephole,
                                           masked, seed=1)
    hs, cs, gates, _, _ = lk.lstm_fwd_plain(xw, rw, p, h0, c0, mask)
    g = torch.Generator().manual_seed(2)
    dhs = torch.randn(T, B, H, generator=g).to(cuda_device)
    dhT, dcT = (torch.randn(B, H, generator=g).to(cuda_device)
                for _ in range(2))
    before = dict(lk.LAUNCHES)
    got = lk.lstm_bwd(rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT, dcT)
    ref = lk.lstm_bwd_plain(rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT,
                            dcT)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["lstm_bwd"] == before["lstm_bwd"] + 1
    assert lk.LAUNCHES["lstm_bwd_weights"] == \
        before["lstm_bwd_weights"] + 1
    for name, a, b in zip(("dxw", "dh0", "dc0", "drw", "dp"), got, ref):
        tol = 1e-4 * max(b.abs().max().item(), 1e-6)
        assert (a - b).abs().max().item() <= tol, name


@pytest.mark.cuda
def test_cuda_fused_lstm_autograd_and_kernel_choice(cuda_device):
    """The autograd Function on the card: B2b under no_grad and when no
    input wants a gradient, B2a and B2c otherwise; gradients against
    autograd through the plain forward; an unused hT/cT is fine."""
    ins = _lstm_inputs(cuda_device, 10, 4, 24, True, True, seed=3)
    lk.reset_counts()
    with torch.no_grad():
        lk.fused_lstm(*ins)
    lk.fused_lstm(*ins)
    assert lk.LAUNCHES == {"lstm_fwd": 0, "lstm_fwd_inference": 2,
                           "lstm_bwd": 0, "lstm_bwd_weights": 0}
    live = [t.clone().requires_grad_() for t in ins[:5]]
    hs, hT, cT = lk.fused_lstm(*live, ins[5])
    grads = torch.autograd.grad((hs * hs).sum(), live)     # hT, cT unused
    assert lk.LAUNCHES["lstm_fwd"] == 1 and lk.LAUNCHES["lstm_bwd"] == 1
    ref_in = [t.clone().requires_grad_() for t in ins[:5]]
    hs_r = lk.lstm_fwd_plain(*ref_in, ins[5])[0]
    ref = torch.autograd.grad((hs_r * hs_r).sum(), ref_in)
    torch.cuda.synchronize()
    for a, b in zip(grads, ref):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.cuda
def test_cuda_lstm_refuses_what_the_kernels_do_not_take(cuda_device):
    xw, rw, p, h0, c0, mask = _lstm_inputs(cuda_device, 4, 2, 8, False,
                                           False)
    with pytest.raises(TypeError):
        lk.lstm_fwd(xw.bfloat16(), rw.bfloat16(), p.bfloat16(),
                    h0.bfloat16(), c0.bfloat16(), mask.bfloat16())
    with pytest.raises(ValueError):
        lk.lstm_fwd(xw.transpose(0, 1).contiguous().transpose(0, 1), rw, p,
                    h0, c0, mask)
    big = lk.MAX_HIDDEN + 8
    with pytest.raises(ValueError):
        lk.lstm_fwd(*_lstm_inputs(cuda_device, 2, 2, big, False, False))


# ----------------------------------------------- quantized decode (B5q, B6q)
QDTYPES = [torch.int8, torch.float8_e4m3fn]


def _quantized(g, shape, dtype, device):
    codes, scales = quantize_kv(torch.randn(*shape, generator=g), dtype)
    return codes.to(device), scales.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
@pytest.mark.parametrize("cdtype", QDTYPES, ids=["int8", "fp8"])
@pytest.mark.parametrize("mode,window,rolling", MODES,
                         ids=[m[0] for m in MODES])
def test_cuda_b5q_matches_plain(cuda_device, mode, window, rolling, cdtype,
                                qdtype):
    g = torch.Generator().manual_seed(13)
    S, L, H, Hkv, Dh = 5, 37, 8, 2, 64
    q = torch.randn(S, H, Dh, generator=g).to(cuda_device, qdtype)
    k, sk = _quantized(g, (S, L, Hkv, Dh), cdtype, cuda_device)
    v, sv = _quantized(g, (S, L, Hkv, Dh), cdtype, cuda_device)
    qpos = torch.tensor([0, 4, 36, 37, 100] if rolling else
                        [0, 4, 20, 30, 36], dtype=torch.int32,
                        device=cuda_device)
    before = dict(ba.LAUNCHES)
    out = ba.banded_decode_attention(q, k, v, qpos, qpos, window=window,
                                     rolling=rolling, scale_k=sk, scale_v=sv)
    # the kernel dequantizes in float32, as the TPU body does; the plain
    # version dequantizes in q's dtype, as JAX's reference does, so with
    # bfloat16 queries it is fed the same queries in float32 and the
    # kernel is held to one bf16 step of that
    ref = ba.decode_attention_plain(q.float(), k, v, qpos, qpos,
                                    window=window, rolling=rolling,
                                    scale_k=sk, scale_v=sv)
    torch.cuda.synchronize()
    assert ba.LAUNCHES["banded_decode_attention_q"] == \
        before["banded_decode_attention_q"] + 1
    assert ba.LAUNCHES["banded_decode_attention"] == \
        before["banded_decode_attention"]
    atol, rtol = (2e-5, 0.0) if qdtype == torch.float32 else \
        (1e-5, 2.0 ** -7)
    ref = ref.float()
    assert ((out.float() - ref).abs() <= atol + rtol * ref.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", QDTYPES, ids=["int8", "fp8"])
@pytest.mark.parametrize("page_len,hkv", [(16, 8), (128, 2), (7, 1)])
def test_cuda_b6q_matches_plain(cuda_device, cdtype, page_len, hkv):
    g = torch.Generator().manual_seed(14)
    S, NP, H, Dh = 4, 256 // page_len, 8, 64
    P = S * NP
    q = torch.randn(S, H, Dh, generator=g).to(cuda_device)
    ck, sk = _quantized(g, (P, page_len, hkv, Dh), cdtype, cuda_device)
    cv, sv = _quantized(g, (P, page_len, hkv, Dh), cdtype, cuda_device)
    pt = torch.randperm(P, generator=g).reshape(S, NP)
    pt[1, :2] = pt[0, :2]
    pt = pt.to(cuda_device, torch.int32)
    qpos = torch.tensor([0, 100, 200, NP * page_len - 1], dtype=torch.int32,
                        device=cuda_device)
    before = ba.LAUNCHES["paged_decode_attention_q"]
    out = ba.paged_decode_attention(q, ck, cv, pt, qpos, scale_k=sk,
                                    scale_v=sv)
    ref = ba.paged_decode_attention_plain(q, ck, cv, pt, qpos, scale_k=sk,
                                          scale_v=sv)
    torch.cuda.synchronize()
    assert ba.LAUNCHES["paged_decode_attention_q"] == before + 1
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_cuda_quantized_wrapper_refuses_missing_scale_rows(cuda_device):
    q = torch.zeros(2, 8, 64, device=cuda_device)
    k = torch.zeros(2, 8, 2, 64, dtype=torch.int8, device=cuda_device)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="scale rows"):
        ba.banded_decode_attention(q, k, k, pos, pos)


# --------------------------------------------------- banded attention (B4)
BANDED_CASES = [
    # (B, T, H, Hkv, Dh, window, causal, dtype)
    (2, 24, 4, 2, 32, 5, True, torch.float32),       # T < one tile
    (1, 37, 4, 4, 64, 1, True, torch.float32),       # window 1
    (2, 100, 8, 2, 64, 200, True, torch.float32),    # window >= T
    (2, 300, 8, 1, 64, 33, False, torch.float32),    # bidirectional, G 8
    (1, 1000, 8, 2, 64, 100, True, torch.float32),   # ragged tail tile
    (2, 200, 4, 2, 128, 64, True, torch.float32),
    (2, 130, 4, 1, 48, 17, False, torch.float32),    # Dh inside a tile
    (2, 300, 8, 2, 64, 64, True, torch.bfloat16),
]


def _banded_inputs(b, t, h, hkv, dh, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)

    def mk(heads):
        return torch.randn(b, t, heads, dh, generator=g).to(device, dtype)
    return mk(h), mk(hkv), mk(hkv), mk(h)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hkv,dh,w,causal,dtype", BANDED_CASES)
def test_cuda_b4_matches_plain(cuda_device, b, t, h, hkv, dh, w, causal,
                               dtype):
    q, k, v, _ = _banded_inputs(b, t, h, hkv, dh, dtype, cuda_device,
                                t + w)
    before = ba.LAUNCHES["banded_attention"]
    o = ba.banded_attention_fwd(q, k, v, w, causal)
    ref = ba.banded_reference(q, k, v, w, causal)
    torch.cuda.synchronize()
    assert ba.LAUNCHES["banded_attention"] == before + 1
    assert _close(o, ref, dtype, 2e-5)
    if w >= t and causal and dtype == torch.float32:
        # a window past T is causal full-context attention
        def fold(x):
            x = torch.repeat_interleave(x, h // x.shape[2], dim=2)
            return x.transpose(1, 2).reshape(b * h, t, dh)

        flat, _ = fa.flash_attention_plain(fold(q), fold(k), fold(v), True)
        assert _close(o, flat.reshape(b, h, t, dh).transpose(1, 2), dtype,
                      2e-5)


@pytest.mark.cuda
def test_cuda_b4_autograd_matches_dense(cuda_device):
    """The autograd Function on the card (B4 forward, dense recompute
    backward) against autograd through the dense band-masked softmax."""
    q, k, v, do = _banded_inputs(2, 150, 8, 2, 64, torch.float32,
                                 cuda_device, 5)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ba.banded_attention(*leaves, 40, True)
    got = torch.autograd.grad(o, leaves, do)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_ref = ba.banded_dense(*ref_leaves, 40, True, 64 ** -0.5)
    want = torch.autograd.grad(o_ref, ref_leaves, do)
    torch.cuda.synchronize()
    assert (o - o_ref).abs().max().item() <= 2e-5
    for g_, r_ in zip(got, want):
        assert (g_ - r_).abs().max().item() <= \
            1e-4 * r_.abs().max().item()


@pytest.mark.cuda
def test_cuda_b4_refuses_head_dims_past_its_tile(cuda_device):
    q = torch.zeros(1, 8, 2, 160, device=cuda_device)
    with pytest.raises(ValueError, match="Dh <= 128"):
        ba.banded_attention_fwd(q, q, q, 4)


# ------------------------------------------ conv + BN statistics (B7a, B7b)
# (M, K, N): ResNet-50 1x1 shapes at small M, and ragged M, K and N
B7A_SHAPES = [(3136, 64, 256), (784, 1024, 256), (98, 2048, 512),
              (1000, 37, 130), (129, 19, 65), (1, 1, 1)]
# (B, H, W, C_in, C_out): a 7x7 map at batch 3, ragged channels
B7B_SHAPES = [(3, 7, 7, 64, 64), (2, 14, 14, 32, 48), (2, 5, 6, 3, 4),
              (1, 1, 1, 5, 7)]


def _stats_close(got, ref, y_ref, dtype):
    """y within 2e-5 of its largest magnitude in float32 (sums of K
    products in another order) or one bf16 step; Σy and Σy² within 1e-5
    of Σ|y| and Σy² (sums of M values in another order)."""
    y, s, q = got
    yr, sr, qr = ref
    yf, yrf = y.float(), yr.float()
    if dtype == torch.float32:
        ok_y = (yf - yrf).abs().max().item() <= \
            2e-5 * max(1.0, yrf.abs().max().item())
    else:
        ok_y = bool(((yf - yrf).abs() <= 1e-5 + 2.0 ** -7 * yrf.abs()).all())
    scale = y_ref.abs().reshape(-1, y_ref.shape[-1]).sum(0) + 1e-6
    ok_s = bool(((s - sr).abs() <= 1e-5 * scale).all())
    ok_q = bool(((q - qr).abs() <= 1e-5 * qr.abs() + 1e-6).all())
    return ok_y and ok_s and ok_q


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", B7A_SHAPES)
def test_cuda_b7a_matches_plain(cuda_device, m, k, n, dtype):
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g).to(cuda_device, dtype)
    w = (torch.randn(k, n, generator=g) / k ** 0.5).to(cuda_device, dtype)
    before = cfk.LAUNCHES["conv1x1_bn_stats"]
    got = cfk.matmul_with_channel_stats(x, w)
    ref = cfk.matmul_with_channel_stats_plain(x, w)
    torch.cuda.synchronize()
    assert cfk.LAUNCHES["conv1x1_bn_stats"] == before + 1
    assert got[1].dtype == torch.float32 and got[0].dtype == dtype
    assert _stats_close(got, ref, x.float() @ w.float(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,cin,cout", B7B_SHAPES)
def test_cuda_b7b_matches_plain(cuda_device, b, h, w, cin, cout, dtype):
    g = torch.Generator().manual_seed(b + h + w + cin + cout)
    x = torch.randn(b, h, w, cin, generator=g).to(cuda_device, dtype)
    wt = (torch.randn(3, 3, cin, cout, generator=g)
          / (9 * cin) ** 0.5).to(cuda_device, dtype)
    before = cfk.LAUNCHES["conv3x3_bn_stats"]
    got = cfk.conv3x3_with_channel_stats(x, wt)
    ref = cfk.conv3x3_with_channel_stats_plain(x, wt)
    torch.cuda.synchronize()
    assert cfk.LAUNCHES["conv3x3_bn_stats"] == before + 1
    assert _stats_close(got, ref, ref[0].float(), dtype)


# every B7 shape of `path_r` (ResNet-50 at batch 128, bfloat16):
# `chip_smoke.b7_path_shapes()`, held equal by `test_torch_conv_fused.py`
B7_PATH_R_SHAPES = [
    ("conv1x1_bn_stats", (6272, 512, 2048)),
    ("conv1x1_bn_stats", (6272, 1024, 512)),
    ("conv1x1_bn_stats", (6272, 1024, 2048)),
    ("conv1x1_bn_stats", (6272, 2048, 512)),
    ("conv1x1_bn_stats", (25088, 256, 1024)),
    ("conv1x1_bn_stats", (25088, 512, 256)),
    ("conv1x1_bn_stats", (25088, 512, 1024)),
    ("conv1x1_bn_stats", (25088, 1024, 256)),
    ("conv1x1_bn_stats", (100352, 128, 512)),
    ("conv1x1_bn_stats", (100352, 256, 128)),
    ("conv1x1_bn_stats", (100352, 256, 512)),
    ("conv1x1_bn_stats", (100352, 512, 128)),
    ("conv1x1_bn_stats", (401408, 64, 64)),
    ("conv1x1_bn_stats", (401408, 64, 256)),
    ("conv1x1_bn_stats", (401408, 256, 64)),
    ("conv3x3_bn_stats", (128, 7, 7, 512, 512)),
    ("conv3x3_bn_stats", (128, 14, 14, 256, 256)),
    ("conv3x3_bn_stats", (128, 28, 28, 128, 128)),
    ("conv3x3_bn_stats", (128, 56, 56, 64, 64)),
]
# bfloat16 shapes design 2 takes with M off its 128-row tile, N off the
# block's columns, K or C off the 64-deep slice
B7_RAGGED_WGMMA = [
    ("conv1x1_bn_stats", (147, 2048, 512)),
    ("conv1x1_bn_stats", (1000, 40, 136)),
    ("conv1x1_bn_stats", (77, 8, 8)),
    ("conv3x3_bn_stats", (3, 7, 7, 512, 512)),
    ("conv3x3_bn_stats", (2, 5, 6, 8, 16)),
    ("conv3x3_bn_stats", (2, 14, 14, 32, 48)),
]


def _b7_inputs(kernel, shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    if kernel == "conv1x1_bn_stats":
        m, k, n = shape
        x = torch.randn(m, k, generator=g)
        w = torch.randn(k, n, generator=g) / k ** 0.5
        run, plain = cfk.matmul_with_channel_stats, \
            cfk.matmul_with_channel_stats_plain
    else:
        b, h, wd, cin, n = shape
        x = torch.randn(b, h, wd, cin, generator=g)
        w = torch.randn(3, 3, cin, n, generator=g) / (9 * cin) ** 0.5
        run, plain = cfk.conv3x3_with_channel_stats, \
            cfk.conv3x3_with_channel_stats_plain
    return x.to(device, dtype), w.to(device, dtype), run, plain


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", B7_PATH_R_SHAPES + B7_RAGGED_WGMMA,
                         ids=[f"{k[:7]}-{'x'.join(map(str, s))}" for k, s in
                              B7_PATH_R_SHAPES + B7_RAGGED_WGMMA])
def test_cuda_b7_bf16_takes_the_wgmma_design(cuda_device, kernel, shape):
    """Design 2 (wgmma fed by TMA) on every path_r bfloat16 shape and on
    ragged ones, against the plain version at `_stats_close`'s
    tolerances; the launch is counted under design 2."""
    x, w, run, plain = _b7_inputs(kernel, shape, torch.bfloat16,
                                  cuda_device, sum(shape))
    before = cfk.LAUNCHES_BY_DESIGN[(kernel, "wgmma")]
    got = run(x, w)
    ref = plain(x, w)
    torch.cuda.synchronize()
    assert cfk.LAUNCHES_BY_DESIGN[(kernel, "wgmma")] == before + 1
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert _stats_close(got, ref, ref[0].float(), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("conv1x1_bn_stats", (401408, 64, 256)),
    ("conv1x1_bn_stats", (147, 2048, 512)),
    ("conv3x3_bn_stats", (128, 14, 14, 256, 256)),
    ("conv3x3_bn_stats", (3, 7, 7, 512, 512))])
def test_cuda_b7_wgmma_statistics_are_bit_equal(cuda_device, kernel, shape):
    x, w, run, _ = _b7_inputs(kernel, shape, torch.bfloat16, cuda_device, 3)
    before = cfk.LAUNCHES_BY_DESIGN[(kernel, "wgmma")]
    a, b = run(x, w), run(x, w)
    torch.cuda.synchronize()
    assert cfk.LAUNCHES_BY_DESIGN[(kernel, "wgmma")] == before + 2
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape,dtype", [
    ("conv1x1_bn_stats", (3136, 64, 256), torch.float32),
    ("conv3x3_bn_stats", (3, 7, 7, 64, 64), torch.float32),
    ("conv1x1_bn_stats", (1000, 37, 130), torch.bfloat16),
    ("conv1x1_bn_stats", (129, 19, 65), torch.bfloat16),
    ("conv3x3_bn_stats", (2, 5, 6, 3, 4), torch.bfloat16)])
def test_cuda_b7_float32_and_unaligned_take_the_ffma_design(
        cuda_device, kernel, shape, dtype):
    x, w, run, plain = _b7_inputs(kernel, shape, dtype, cuda_device, 4)
    before = dict(cfk.LAUNCHES_BY_DESIGN)
    got = run(x, w)
    ref = plain(x, w)
    torch.cuda.synchronize()
    assert cfk.LAUNCHES_BY_DESIGN[(kernel, "ffma")] == \
        before[(kernel, "ffma")] + 1
    assert cfk.LAUNCHES_BY_DESIGN[(kernel, "wgmma")] == \
        before[(kernel, "wgmma")]
    assert _stats_close(got, ref, ref[0].float(), dtype)


@pytest.mark.cuda
def test_cuda_b7_unaligned_bf16_pointer_takes_the_ffma_design(cuda_device):
    """A contiguous view 8 bytes into its storage is not 16-byte aligned:
    the tensor maps cannot read it, so design 1 takes it."""
    g = torch.Generator().manual_seed(5)
    buf = torch.randn(4 + 256 * 64, generator=g).to(cuda_device,
                                                    torch.bfloat16)
    x = buf[4:].view(256, 64)
    w = (torch.randn(64, 128, generator=g) / 8).to(cuda_device,
                                                   torch.bfloat16)
    before = cfk.LAUNCHES_BY_DESIGN[("conv1x1_bn_stats", "ffma")]
    got = cfk.matmul_with_channel_stats(x, w)
    ref = cfk.matmul_with_channel_stats_plain(x, w)
    torch.cuda.synchronize()
    assert cfk.LAUNCHES_BY_DESIGN[("conv1x1_bn_stats", "ffma")] == \
        before + 1
    assert _stats_close(got, ref, ref[0].float(), torch.bfloat16)


@pytest.mark.cuda
def test_cuda_b7_statistics_are_deterministic(cuda_device):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(40000, 64, generator=g).to(cuda_device)
    w = torch.randn(64, 96, generator=g).to(cuda_device)
    a = cfk.matmul_with_channel_stats(x, w)
    b = cfk.matmul_with_channel_stats(x, w)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_cuda_b7_refuses_other_dtypes(cuda_device, dtype):
    x = torch.zeros(4, 8, dtype=dtype, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cfk.matmul_with_channel_stats(x, torch.zeros(8, 4, dtype=dtype,
                                                     device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,stride", [("1x1", 1), ("1x1", 2),
                                         ("3x3", 1)])
def test_cuda_fused_conv_bn_train_matches_cpu(cuda_device, kind, stride):
    """The training Functions on the card (B7a/B7b forward, the BN
    backward and the transposes / cuDNN convolution backward) against the
    same on the CPU (plain versions), float32 with TF32 off: outputs
    within 1e-4, gradients within 1e-4 of each gradient's largest."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(stride)
    k3 = kind == "3x3"
    x = torch.randn(4, 9, 9, 32, generator=g)
    w = torch.randn(*((3, 3, 32, 48) if k3 else (32, 48)), generator=g) \
        / (32 * (9 if k3 else 1)) ** 0.5
    gamma = 1.0 + 0.2 * torch.randn(48, generator=g)
    beta = 0.1 * torch.randn(48, generator=g)
    r = torch.randn(4, -(-9 // stride), -(-9 // stride), 48, generator=g)
    res = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.to(dev).requires_grad_() for t in (x, w, gamma, beta)]
        if k3:
            out, m, v = cfk.conv3x3_bn_act(*leaves, train=True)
        else:
            out, m, v = cfk.conv1x1_bn_act(*leaves, stride=(stride, stride),
                                           train=True)
        grads = torch.autograd.grad((out * r.to(dev)).sum(), leaves)
        res[str(dev)] = [t.cpu() for t in (out, m, v, *grads)]
    torch.backends.cudnn.allow_tf32 = tf32
    for a, b in zip(res["cpu"], res[str(cuda_device)]):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, a.abs().max())
