"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the decode kernels B5 and B6 (native, and their int8/e4m3
scale-row variants B5q and B6q; each in both designs), the banded
attention B4 (both designs), the
flash-attention forward B3a and backward B3b/B3c (each in both designs),
the fused Adam B1a and Nesterovs B1b, the fused LSTM forward B2a/B2b and
backward B2c (both designs of each), and the conv+BN statistics kernels B7a/B7b.
These tests import only torch, so they run on a machine with a card and
no JAX:

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
round once; on the bfloat16 flash gradients 1e-3 of the largest
magnitude (`_grad_atol`), and on the outputs of B3a's tensor-core design
`ops/attention.FWD_WGMMA_SHARE` of it besides (`fwd_atol`): P and dS are
rounded to bfloat16 operands on both sides, from scores summed in
another order. The fused Adam kernel rounds
every operation as the plain version's elementwise ops do, so it is held
to 2**-22 relative (two float32 ulps) and, in bfloat16, one bf16 step; so
is the fused Nesterovs kernel. The LSTM kernels sum H products a step in another order than the
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


# (dtype, atol, rtol, design): float32 queries in both designs of B5/B5q,
# bfloat16 on design 1 alone (`b5_design`)
B5_DESIGN_CASES = [(torch.float32, 2e-5, 0.0, "ffma"),
                   (torch.float32, 2e-5, 0.0, "split"),
                   (torch.bfloat16, 1e-5, 2.0 ** -7, "ffma")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol,design", B5_DESIGN_CASES,
                         ids=["f32-ffma", "f32-split", "bf16-ffma"])
@pytest.mark.parametrize("mode,window,rolling", MODES,
                         ids=[m[0] for m in MODES])
def test_cuda_b5_matches_plain(cuda_device, mode, window, rolling, dtype,
                               atol, rtol, design):
    g = torch.Generator().manual_seed(3)
    S, L, H, Hkv, Dh = 5, 37, 8, 2, 64          # ragged last tile
    q = torch.randn(S, H, Dh, generator=g).to(cuda_device, dtype)
    k = torch.randn(S, L, Hkv, Dh, generator=g).to(cuda_device, dtype)
    v = torch.randn(S, L, Hkv, Dh, generator=g).to(cuda_device, dtype)
    qpos = torch.tensor([0, 4, 36, 37, 100] if rolling else
                        [0, 4, 20, 30, 36], dtype=torch.int32,
                        device=cuda_device)
    before = dict(ba.LAUNCHES_BY_DESIGN)
    out = ba.banded_decode_attention(q, k, v, qpos, qpos, window=window,
                                     rolling=rolling, design=design)
    ref = ba.decode_attention_plain(q, k, v, qpos, qpos, window=window,
                                    rolling=rolling)
    torch.cuda.synchronize()
    key = ("banded_decode_attention", design)
    assert ba.LAUNCHES_BY_DESIGN[key] == before[key] + 1
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
@pytest.mark.parametrize("page_len,hkv", [(8, 8), (128, 2)])
def test_cuda_b6_bf16_matches_plain(cuda_device, page_len, hkv):
    """bfloat16 pages: the kernel rounds p against the row max, found by
    its first sweep over the K rows, as the plain version does (C6)."""
    g = torch.Generator().manual_seed(6)
    S, NP, H, Dh = 4, 256 // page_len, 8, 64
    P = S * NP
    q, ck, cv = (torch.randn(*shape, generator=g).to(cuda_device,
                                                     torch.bfloat16)
                 for shape in ((S, H, Dh), (P, page_len, hkv, Dh),
                               (P, page_len, hkv, Dh)))
    pt = torch.randperm(P, generator=g).reshape(S, NP).to(cuda_device,
                                                          torch.int32)
    qpos = torch.tensor([0, 100, 200, 255], dtype=torch.int32,
                        device=cuda_device)
    before = ba.LAUNCHES["paged_decode_attention"]
    out = ba.paged_decode_attention(q, ck, cv, pt, qpos, window=150)
    ref = ba.paged_decode_attention_plain(q, ck, cv, pt, qpos, window=150)
    torch.cuda.synchronize()
    assert ba.LAUNCHES["paged_decode_attention"] == before + 1
    ref = ref.float()
    assert ((out.float() - ref).abs() <= 1e-5 + 2.0 ** -7 * ref.abs()).all()


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
    # cross-attention (path_x): not causal, Tq != Tk, a tail key tile, on
    # design 1 (design 2's bf16 case is in B3_WGMMA_CASES)
    (2, 2048, 1000, 64, False, torch.float32),
]


def _flash_inputs(bh, tq, tk, dh, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    mk = lambda t: torch.randn(bh, t, dh, generator=g).to(device, dtype)  # noqa
    return mk(tq), mk(tk), mk(tk), mk(tq)


def _grad_atol(ref, dtype):
    """Absolute tolerance of a flash gradient against the plain version:
    1e-4 of the largest |ref| in float32; in bfloat16 1e-3 of it, in both
    designs. There both sides round P and dS to bfloat16 before the
    second products (C6), from float32 values that differ in their last
    bits wherever their sums run in another order (tensor-core or FMA
    against cuBLAS sums), so an operand can land one bf16 step apart and
    move an output row by that step times its partner (`chip_smoke.py`'s
    flash rows read it: past 1e-4 on design 1 at Dh 32, T 1024, as on
    design 2 at T 2048); 1e-3 is also the bound the plain version is held
    to against the Pallas kernels, and the kernels against the plain
    version left unrounded miss it."""
    scale = 1e-3 if dtype == torch.bfloat16 else 1e-4
    return scale * ref.float().abs().max().item()


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
    """float32: design 1 within 2e-5. bfloat16 (C7): both designs on the
    same inputs, design 1 within 2e-5 plus one bf16 step, design 2 (the
    wrapper's choice at Dh 64) within `fwd_atol(o_ref, "wgmma")` and
    nearer the plain version that rounds p than the one that does not —
    its tensor-core score sums differ from the plain version's in the
    last bits, and the plain version misses 2e-5 plus a step against
    itself under another exact summation order
    (`test_plain_b3a_bf16_misses_a_step_against_itself_in_another_sum_
    order`); the lse within 2e-5 in both."""
    q, k, v, _ = _flash_inputs(bh, tq, tk, dh, dtype, cuda_device, tq + dh)
    before = fa.LAUNCHES["flash_attention_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    # bfloat16 rounds p against the running max of the kernel's key tile
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal,
                                              block_k=fa.KERNEL_BLOCK_K)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    assert (lse - lse_ref).abs().max().item() <= 2e-5
    if dtype == torch.bfloat16:
        assert fa.b3_design(dtype, dh, (q, k, v)) == "wgmma"
        o1, lse1 = fa.launch_fwd(q, k, v, causal, design="ffma")
        torch.cuda.synchronize()
        assert _close(o1, o_ref, dtype, 2e-5)
        assert (lse1 - lse_ref).abs().max().item() <= 2e-5
        assert _close(o, o_ref, dtype, fa.fwd_atol(o_ref, "wgmma"))
        o_f32, _ = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            causal)
        rf = o_ref.float()
        past = (o.float() - rf).abs() - 2.0 ** -7 * rf.abs()
        past_f32 = (o.float() - o_f32).abs() - 2.0 ** -7 * o_f32.abs()
        assert past.max().item() < past_f32.max().item()
    else:
        assert _close(o, o_ref, dtype, 2e-5)
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


# bfloat16 shapes of design 2 (wgmma): path_t_bf16's, a ragged T, Tq != Tk
# not causal, Dh 128 causal and not
B3_WGMMA_CASES = [(64, 2048, 2048, 64, True), (3, 1000, 1000, 64, True),
                  (2, 130, 77, 64, False), (2, 200, 200, 128, True),
                  (2, 512, 768, 128, False), (2, 2048, 1000, 64, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,dh,causal", B3_WGMMA_CASES)
def test_cuda_b3b_b3c_bf16_take_the_wgmma_design(cuda_device, bh, tq, tk,
                                                 dh, causal):
    """Design 2 (wgmma fed by TMA) on every bfloat16 Dh 64/128 shape,
    against the plain version (which rounds P and dS as the kernel does)
    at `test_cuda_b3b_b3c_match_plain`'s tolerance; both launches counted
    under design 2."""
    dt = torch.bfloat16
    q, k, v, do = _flash_inputs(bh, tq, tk, dh, dt, cuda_device, tq + tk)
    o, lse = fa.flash_attention_plain(q, k, v, causal)
    before = dict(fa.LAUNCHES_BY_DESIGN)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for kern in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        assert fa.LAUNCHES_BY_DESIGN[(kern, "wgmma")] == \
            before[(kern, "wgmma")] + 1
        assert fa.LAUNCHES_BY_DESIGN[(kern, "ffma")] == \
            before[(kern, "ffma")]
    for g_, r_ in zip(got, ref):
        assert g_.dtype == dt
        assert _close(g_, r_, dt, _grad_atol(r_, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,dh,causal", [B3_WGMMA_CASES[0],
                                                 B3_WGMMA_CASES[3]])
def test_cuda_b3_wgmma_gradients_are_bit_equal(cuda_device, bh, tq, tk, dh,
                                               causal):
    """No atomics: two launches of design 2 give the same bits."""
    q, k, v, do = _flash_inputs(bh, tq, tk, dh, torch.bfloat16, cuda_device,
                                3)
    o, lse = fa.flash_attention_plain(q, k, v, causal)
    a = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    b = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dtype", [(32, torch.bfloat16),
                                      (48, torch.bfloat16),
                                      (64, torch.float32),
                                      (128, torch.float32)])
def test_cuda_b3_float32_and_other_head_dims_take_the_ffma_design(
        cuda_device, dh, dtype):
    q, k, v, do = _flash_inputs(2, 256, 256, dh, dtype, cuda_device, dh)
    o, lse = fa.flash_attention_plain(q, k, v, True)
    before = dict(fa.LAUNCHES_BY_DESIGN)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    for kern in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        assert fa.LAUNCHES_BY_DESIGN[(kern, "ffma")] == \
            before[(kern, "ffma")] + 1
        assert fa.LAUNCHES_BY_DESIGN[(kern, "wgmma")] == \
            before[(kern, "wgmma")]
    for g_, r_ in zip(got, ref):
        assert _close(g_, r_, dtype, _grad_atol(r_, dtype))


@pytest.mark.cuda
def test_cuda_b3_unaligned_bf16_takes_the_ffma_design(cuda_device):
    """A contiguous q 8 bytes into its storage: the tensor maps cannot
    read it, so design 1 takes the call."""
    g = torch.Generator().manual_seed(9)
    buf = torch.randn(4 + 2 * 128 * 64, generator=g).to(cuda_device,
                                                        torch.bfloat16)
    q = buf[4:].view(2, 128, 64)
    _, k, v, do = _flash_inputs(2, 128, 128, 64, torch.bfloat16, cuda_device,
                                10)
    assert fa.b3_design(q.dtype, 64, (q, k, v, do)) == "ffma"
    o, lse = fa.flash_attention_plain(q, k, v, True)
    before = fa.LAUNCHES_BY_DESIGN[("flash_attention_bwd_dq", "ffma")]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BY_DESIGN[("flash_attention_bwd_dq", "ffma")] == \
        before + 1
    for g_, r_ in zip(got, ref):
        assert _close(g_, r_, torch.bfloat16,
                      _grad_atol(r_, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [True, False], ids=["lse", "no_lse"])
@pytest.mark.parametrize("bh,tq,tk,dh,causal", B3_WGMMA_CASES)
def test_cuda_b3a_bf16_takes_the_wgmma_design(cuda_device, bh, tq, tk, dh,
                                              causal, with_lse):
    """B3a design 2 on every bfloat16 Dh 64/128 shape (causal, Tq != Tk
    not causal, a ragged T), with and without the lse, against the plain
    version rounding p against the kernel's 64-key tiles, at design 2's
    tolerance (`fwd_atol`); the launch counted under design 2."""
    dt = torch.bfloat16
    q, k, v, _ = _flash_inputs(bh, tq, tk, dh, dt, cuda_device, tq + 3 * dh)
    assert fa.b3_design(dt, dh, (q, k, v)) == "wgmma"
    before = dict(fa.LAUNCHES_BY_DESIGN)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, with_lse=with_lse)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal,
                                              block_k=fa.KERNEL_BLOCK_K)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BY_DESIGN[("flash_attention_fwd", "wgmma")] == \
        before[("flash_attention_fwd", "wgmma")] + 1
    assert fa.LAUNCHES_BY_DESIGN[("flash_attention_fwd", "ffma")] == \
        before[("flash_attention_fwd", "ffma")]
    assert o.dtype == dt and _close(o, o_ref, dt, fa.fwd_atol(o_ref, "wgmma"))
    # C6: nearer the plain version that rounds p than the one that does not
    o_f32, _ = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal)
    past = (o.float() - o_ref.float()).abs() - 2.0 ** -7 * o_ref.float().abs()
    past_f32 = (o.float() - o_f32).abs() - 2.0 ** -7 * o_f32.abs()
    assert past.max().item() < past_f32.max().item()
    if with_lse:
        assert (lse - lse_ref).abs().max().item() <= 2e-5
    else:
        assert lse is None


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,dh,causal", [B3_WGMMA_CASES[0],
                                                 B3_WGMMA_CASES[4]])
def test_cuda_b3a_wgmma_is_bit_equal(cuda_device, bh, tq, tk, dh, causal):
    """No atomics: two launches of design 2 give the same o and lse."""
    q, k, v, _ = _flash_inputs(bh, tq, tk, dh, torch.bfloat16, cuda_device,
                               4)
    a = fa.flash_attention_fwd(q, k, v, causal)
    b = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dtype", [(32, torch.bfloat16),
                                      (48, torch.bfloat16),
                                      (64, torch.float32),
                                      (128, torch.float32)])
def test_cuda_b3a_float32_and_other_head_dims_take_the_ffma_design(
        cuda_device, dh, dtype):
    q, k, v, _ = _flash_inputs(2, 256, 256, dh, dtype, cuda_device, dh + 1)
    before = dict(fa.LAUNCHES_BY_DESIGN)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, True,
                                              block_k=fa.KERNEL_BLOCK_K)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BY_DESIGN[("flash_attention_fwd", "ffma")] == \
        before[("flash_attention_fwd", "ffma")] + 1
    assert fa.LAUNCHES_BY_DESIGN[("flash_attention_fwd", "wgmma")] == \
        before[("flash_attention_fwd", "wgmma")]
    assert _close(o, o_ref, dtype, 2e-5)
    assert (lse - lse_ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_cuda_b3a_unaligned_bf16_takes_the_ffma_design(cuda_device):
    """q 8 bytes into its storage: the tensor maps cannot read it, so
    design 1 takes the forward too; an aligned copy of q goes to design 2,
    and both agree with the plain version."""
    g = torch.Generator().manual_seed(12)
    buf = torch.randn(4 + 2 * 128 * 64, generator=g).to(cuda_device,
                                                        torch.bfloat16)
    q = buf[4:].view(2, 128, 64)
    _, k, v, _ = _flash_inputs(2, 128, 128, 64, torch.bfloat16, cuda_device,
                               13)
    assert fa.b3_design(q.dtype, 64, (q, k, v)) == "ffma"
    before = fa.LAUNCHES_BY_DESIGN[("flash_attention_fwd", "ffma")]
    o, _ = fa.flash_attention_fwd(q, k, v, True)
    o2, _ = fa.flash_attention_fwd(q.contiguous().clone(), k, v, True)
    o_ref, _ = fa.flash_attention_plain(q, k, v, True,
                                        block_k=fa.KERNEL_BLOCK_K)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BY_DESIGN[("flash_attention_fwd", "ffma")] == \
        before + 1
    for got, design in ((o, "ffma"), (o2, "wgmma")):
        assert _close(got, o_ref, torch.bfloat16, fa.fwd_atol(o_ref, design))


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
@pytest.mark.parametrize("design", lk.DESIGNS)
@pytest.mark.parametrize("residuals", [True, False], ids=["b2a", "b2b"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES,
                         ids=[f"T{t}B{b}H{h}" for t, b, h in LSTM_SHAPES])
def test_cuda_b2ab_each_design_matches_plain(cuda_device, T, B, H, masked,
                                             residuals, design):
    """Each design launched by hand at every shape, whichever `b2_design`
    picks there, with peepholes, at `test_cuda_b2ab_match_plain`'s
    tolerance."""
    ins = _lstm_inputs(cuda_device, T, B, H, True, masked, seed=4)
    name = "lstm_fwd" if residuals else "lstm_fwd_inference"
    before = lk.LAUNCHES_BY_DESIGN[(name, design)]
    got = lk.launch_fwd(*ins, with_residuals=residuals, design=design)
    ref = lk.lstm_fwd_plain(*ins, with_residuals=True)
    torch.cuda.synchronize()
    assert lk.LAUNCHES_BY_DESIGN[(name, design)] == before + 1
    for name, a, b in zip(("hs", "cs", "gates", "hT", "cT"), got, ref):
        if a is None:
            assert not residuals and name in ("cs", "gates")
            continue
        tol = 1e-4 * max(1.0, b.abs().max().item()) \
            if name in ("cs", "cT") else 1e-4
        assert (a - b).abs().max().item() <= tol, name


# path_l's shape; path_g's T 200 and the shortest sequence design 2 takes
# at B 32, H 256; lstm_parity's batch of 4
B2_PERSISTENT_SHAPES = [(128, 64, 512), (200, 32, 256),
                        (lk.PERSISTENT_MIN_STEPS, 32, 256), (32, 4, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("T,B,H", B2_PERSISTENT_SHAPES,
                         ids=[f"T{t}B{b}H{h}"
                              for t, b, h in B2_PERSISTENT_SHAPES])
def test_cuda_b2a_takes_the_persistent_design(cuda_device, T, B, H, masked,
                                              peephole):
    """Design 2 (the persistent grid) on the recurrent paths' shapes in
    all four peephole/mask variants, against the plain version at
    `test_cuda_b2ab_match_plain`'s tolerance; two launches bit-equal;
    counted under design 2."""
    ins = _lstm_inputs(cuda_device, T, B, H, peephole, masked, seed=T + B)
    sms, smem = lk.card_limits(cuda_device)
    assert lk.b2_design(T, B, H, sms, smem) == "persistent"
    before = dict(lk.LAUNCHES_BY_DESIGN)
    got = lk.lstm_fwd(*ins, with_residuals=True)
    again = lk.lstm_fwd(*ins, with_residuals=True)
    ref = lk.lstm_fwd_plain(*ins, with_residuals=True)
    torch.cuda.synchronize()
    assert lk.LAUNCHES_BY_DESIGN[("lstm_fwd", "persistent")] == \
        before[("lstm_fwd", "persistent")] + 2
    assert lk.LAUNCHES_BY_DESIGN[("lstm_fwd", "cluster")] == \
        before[("lstm_fwd", "cluster")]
    for name, a, b in zip(("hs", "cs", "gates", "hT", "cT"), got, ref):
        tol = 1e-4 * max(1.0, b.abs().max().item()) \
            if name in ("cs", "cT") else 1e-4
        assert (a - b).abs().max().item() <= tol, name
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(8, 64, 1024), (1, 32, 256)],
                         ids=["H1024", "T1"])
def test_cuda_b2_shapes_past_design_2_take_the_cluster_design(cuda_device, T,
                                                              B, H):
    """H 1024 at B 64 (no design-2 tile fits the SMs) and a one-step call
    (`rnn_time_step`'s) go to design 1, still against the plain
    version."""
    ins = _lstm_inputs(cuda_device, T, B, H, True, True, seed=8)
    sms, smem = lk.card_limits(cuda_device)
    assert lk.b2_design(T, B, H, sms, smem) == "cluster"
    before = lk.LAUNCHES_BY_DESIGN[("lstm_fwd_inference", "cluster")]
    got = lk.lstm_fwd(*ins, with_residuals=False)
    ref = lk.lstm_fwd_plain(*ins, with_residuals=False)
    torch.cuda.synchronize()
    assert lk.LAUNCHES_BY_DESIGN[("lstm_fwd_inference", "cluster")] == \
        before + 1
    assert (got[0] - ref[0]).abs().max().item() <= 1e-4


def _b2c_inputs(dev, T, B, H, peephole, masked, seed=1):
    """The backward's inputs: the plain forward's residuals of seeded
    inputs, and seeded cotangents."""
    xw, rw, p, h0, c0, mask = _lstm_inputs(dev, T, B, H, peephole, masked,
                                           seed=seed)
    hs, cs, gates, _, _ = lk.lstm_fwd_plain(xw, rw, p, h0, c0, mask)
    g = torch.Generator().manual_seed(seed + 1)
    dhs = torch.randn(T, B, H, generator=g).to(dev)
    dhT, dcT = (torch.randn(B, H, generator=g).to(dev) for _ in range(2))
    return rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT, dcT


def _b2c_by_hand(bw, rec_design, w_design):
    """B2c's two launches in the given designs: (dxw, dh0, dc0, drw,
    dp)."""
    rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT, dcT = bw
    dxw, dh0, dc0, dp_part = lk.launch_bwd_recurrence(
        rw, p, mask, cs, gates, c0, dhs, dhT, dcT, rec_design)
    drw, dp = lk.launch_bwd_weights(hs, h0, dxw, dp_part, w_design)
    return dxw, dh0, dc0, drw, dp


def _assert_b2c_close(got, ref):
    for name, a, b in zip(("dxw", "dh0", "dc0", "drw", "dp"), got, ref):
        tol = 1e-4 * max(b.abs().max().item(), 1e-6)
        assert (a - b).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("design", [("cluster", "tiled"),
                                    ("persistent", "pipelined")],
                         ids=["design1", "design2"])
@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES[1:],
                         ids=[f"T{t}B{b}H{h}" for t, b, h in LSTM_SHAPES[1:]])
def test_cuda_b2c_matches_plain(cuda_device, T, B, H, masked, peephole,
                                design):
    """Each design of both B2c launches by hand at every shape (H 37 and
    10 take the weight product's 4-byte copies), whichever `b2c_design`
    picks there, against the plain backward."""
    bw = _b2c_inputs(cuda_device, T, B, H, peephole, masked)
    before = dict(lk.LAUNCHES_BY_DESIGN)
    got = _b2c_by_hand(bw, *design)
    ref = lk.lstm_bwd_plain(*bw)
    torch.cuda.synchronize()
    for kernel, d in zip(("lstm_bwd", "lstm_bwd_weights"), design):
        assert lk.LAUNCHES_BY_DESIGN[(kernel, d)] == before[(kernel, d)] + 1
    _assert_b2c_close(got, ref)


# path_l's and path_g's tBPTT shapes; lstm_parity's batch of 4
B2C_PERSISTENT_SHAPES = [(128, 64, 512), (50, 32, 256), (32, 4, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("T,B,H", B2C_PERSISTENT_SHAPES,
                         ids=[f"T{t}B{b}H{h}"
                              for t, b, h in B2C_PERSISTENT_SHAPES])
def test_cuda_b2c_takes_the_persistent_design(cuda_device, T, B, H, masked,
                                              peephole):
    """`lstm_bwd` on the recurrent paths' shapes runs design 2 of both
    launches (the recurrence "persistent", the weight product
    "pipelined"), within `test_cuda_b2c_matches_plain`'s tolerance; two
    calls bit-equal."""
    bw = _b2c_inputs(cuda_device, T, B, H, peephole, masked, seed=T + B)
    sms, smem = lk.card_limits(cuda_device)
    assert lk.b2c_design(T, B, H, sms, smem) == "persistent"
    before = dict(lk.LAUNCHES_BY_DESIGN)
    got = lk.lstm_bwd(*bw)
    again = lk.lstm_bwd(*bw)
    ref = lk.lstm_bwd_plain(*bw)
    torch.cuda.synchronize()
    for kernel, (d1, d2) in lk.B2C_DESIGNS.items():
        assert lk.LAUNCHES_BY_DESIGN[(kernel, d2)] == before[(kernel, d2)] + 2
        assert lk.LAUNCHES_BY_DESIGN[(kernel, d1)] == before[(kernel, d1)]
    _assert_b2c_close(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(8, 64, 1024), (4, 32, 256)],
                         ids=["H1024", "T4"])
def test_cuda_b2c_shapes_past_design_2_take_the_cluster_design(cuda_device,
                                                               T, B, H):
    """H 1024 at B 64 (no design-2 grid fits the SMs) and a sequence
    shorter than PERSISTENT_MIN_STEPS run the recurrence on design 1;
    the weight product stays on "pipelined"."""
    bw = _b2c_inputs(cuda_device, T, B, H, True, True, seed=8)
    sms, smem = lk.card_limits(cuda_device)
    assert lk.b2c_design(T, B, H, sms, smem) == "cluster"
    before = dict(lk.LAUNCHES_BY_DESIGN)
    got = lk.lstm_bwd(*bw)
    ref = lk.lstm_bwd_plain(*bw)
    torch.cuda.synchronize()
    assert lk.LAUNCHES_BY_DESIGN[("lstm_bwd", "cluster")] == \
        before[("lstm_bwd", "cluster")] + 1
    assert lk.LAUNCHES_BY_DESIGN[("lstm_bwd_weights", "pipelined")] == \
        before[("lstm_bwd_weights", "pipelined")] + 1
    _assert_b2c_close(got, ref)
    if H == 1024:
        with pytest.raises(ValueError, match="no design-2 LSTM backward"):
            lk.launch_bwd_recurrence(*bw[:3], *bw[4:6], bw[7], *bw[8:],
                                     "persistent")


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
@pytest.mark.parametrize("qdtype,design",
                         [(torch.float32, "ffma"), (torch.float32, "split"),
                          (torch.bfloat16, "ffma")],
                         ids=["q_f32-ffma", "q_f32-split", "q_bf16-ffma"])
@pytest.mark.parametrize("cdtype", QDTYPES, ids=["int8", "fp8"])
@pytest.mark.parametrize("mode,window,rolling", MODES,
                         ids=[m[0] for m in MODES])
def test_cuda_b5q_matches_plain(cuda_device, mode, window, rolling, cdtype,
                                qdtype, design):
    g = torch.Generator().manual_seed(13)
    S, L, H, Hkv, Dh = 5, 37, 8, 2, 64
    q = torch.randn(S, H, Dh, generator=g).to(cuda_device, qdtype)
    k, sk = _quantized(g, (S, L, Hkv, Dh), cdtype, cuda_device)
    v, sv = _quantized(g, (S, L, Hkv, Dh), cdtype, cuda_device)
    qpos = torch.tensor([0, 4, 36, 37, 100] if rolling else
                        [0, 4, 20, 30, 36], dtype=torch.int32,
                        device=cuda_device)
    before = dict(ba.LAUNCHES)
    by_design = dict(ba.LAUNCHES_BY_DESIGN)
    out = ba.banded_decode_attention(q, k, v, qpos, qpos, window=window,
                                     rolling=rolling, scale_k=sk, scale_v=sv,
                                     design=design)
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
    key = ("banded_decode_attention_q", design)
    assert ba.LAUNCHES_BY_DESIGN[key] == by_design[key] + 1
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


# ------------------------------------- B6 / B6q design 2 ("split")
B6_CACHES = [torch.float32, torch.int8, torch.float8_e4m3fn]


def _pages(g, shape, cdtype, device):
    """(cache, scale rows or None) of `cdtype` from seeded normals."""
    if cdtype == torch.float32:
        return torch.randn(*shape, generator=g).to(device), None
    return _quantized(g, shape, cdtype, device)


def _paged_case(device, cdtype, page_len, hkv, dh, seed, L=1024, S=4, H=8):
    """q, caches, scale rows, a page table whose slot 1 shares slot 0's
    first two pages, and positions from 0 (one key: most splits lie past
    it) to the table's last, the rest of S > 4 slots spread between."""
    g = torch.Generator().manual_seed(seed)
    NP = L // page_len
    P = S * NP
    q = torch.randn(S, H, dh, generator=g).to(device)
    ck, sk = _pages(g, (P, page_len, hkv, dh), cdtype, device)
    cv, sv = _pages(g, (P, page_len, hkv, dh), cdtype, device)
    pt = torch.randperm(P, generator=g).reshape(S, NP)
    pt[1, :2] = pt[0, :2]
    pt = pt.to(device, torch.int32)
    qpos = torch.tensor([0, 2 * page_len - 1, L // 2 + 3, L - 1]
                        + torch.linspace(1, L - 2, S).long().tolist()[4:],
                        dtype=torch.int32, device=device)[:S]
    return q, ck, cv, sk, sv, pt, qpos


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 200], ids=["full", "window"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("page_len,hkv", [(128, 8), (16, 8), (128, 2),
                                          (16, 2)])
@pytest.mark.parametrize("cdtype", B6_CACHES, ids=["f32", "int8", "fp8"])
def test_cuda_b6_split_matches_plain(cuda_device, cdtype, page_len, hkv, dh,
                                     window):
    """Design 2 of B6 (float32 pages) and B6q (int8, e4m3) against the
    plain version at the B6/B6q tolerance (2e-5): every split a block's
    pages allow, splits wholly past qpos (slot 0 sees one key), a range
    ending on a page boundary, shared prefix pages, a window; the launch
    counted under "split"."""
    q, ck, cv, sk, sv, pt, qpos = _paged_case(cuda_device, cdtype, page_len,
                                              hkv, dh, page_len + hkv + dh)
    name = "paged_decode_attention" + ("" if sk is None else "_q")
    assert ba.b6_design(q.dtype, ck.dtype, 8, hkv, dh, (ck, cv)) == "split"
    nsplit = -(-pt.shape[1] // ba.b6_splits(
        4, hkv, pt.shape[1], page_len, ba._sm_count(q.device)))
    assert nsplit > 1
    before = dict(ba.LAUNCHES_BY_DESIGN)
    out = ba.paged_decode_attention(q, ck, cv, pt, qpos, window=window,
                                    scale_k=sk, scale_v=sv)
    ref = ba.paged_decode_attention_plain(q, ck, cv, pt, qpos, window=window,
                                          scale_k=sk, scale_v=sv)
    torch.cuda.synchronize()
    assert ba.LAUNCHES_BY_DESIGN[(name, "split")] == \
        before[(name, "split")] + 1
    assert ba.LAUNCHES_BY_DESIGN[(name, "ffma")] == before[(name, "ffma")]
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", B6_CACHES, ids=["f32", "int8", "fp8"])
def test_cuda_b6_split_is_bit_equal_and_design_1_agrees(cuda_device, cdtype):
    """Two launches of design 2 give the same bits (the last block to
    arrive merges the splits in split order); design 1 on the same inputs
    agrees within 2e-5."""
    q, ck, cv, sk, sv, pt, qpos = _paged_case(cuda_device, cdtype, 128, 8,
                                              64, 31, L=2048, S=8)
    a = ba.paged_decode_attention(q, ck, cv, pt, qpos, scale_k=sk,
                                  scale_v=sv)
    b = ba.paged_decode_attention(q, ck, cv, pt, qpos, scale_k=sk,
                                  scale_v=sv)
    one = ba.paged_decode_attention(q, ck, cv, pt, qpos, scale_k=sk,
                                    scale_v=sv, design="ffma")
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert (a - one).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", B6_CACHES, ids=["f32", "int8", "fp8"])
def test_cuda_b6_split_nan_query_and_empty_rows(cuda_device, cdtype):
    """The paged counterpart of `test_cuda_nan_query_and_empty_rows` on
    design 2: a NaN query comes out NaN (the merge keeps it), a slot at
    qpos -1 sees no key and comes out as zeros, as on design 1."""
    q, ck, cv, sk, sv, pt, _ = _paged_case(cuda_device, cdtype, 16, 2, 64, 9)
    q[1] = float("nan")
    qpos = torch.tensor([5, 700, -1, 1023], dtype=torch.int32,
                        device=cuda_device)
    outs = {d: ba.paged_decode_attention(q, ck, cv, pt, qpos, scale_k=sk,
                                         scale_v=sv, design=d)
            for d in ba.DESIGNS}
    torch.cuda.synchronize()
    for out in outs.values():
        assert torch.isfinite(out[[0, 3]]).all()
        assert torch.isnan(out[1]).all()
        assert torch.equal(out[2], torch.zeros_like(out[2]))


@pytest.mark.cuda
def test_cuda_b6_bf16_and_other_head_dims_take_design_1(cuda_device):
    """bfloat16 pages (C6b: p rounded against the row max) and head dims
    other than 64 and 128 are counted under design 1; design 2 refuses
    them when named."""
    g = torch.Generator().manual_seed(5)
    for dtype, dh in ((torch.bfloat16, 64), (torch.float32, 80)):
        q = torch.randn(2, 8, dh, generator=g).to(cuda_device, dtype)
        ck = torch.randn(4, 16, 2, dh, generator=g).to(cuda_device, dtype)
        pt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32,
                          device=cuda_device)
        qpos = torch.tensor([3, 30], dtype=torch.int32, device=cuda_device)
        before = dict(ba.LAUNCHES_BY_DESIGN)
        ba.paged_decode_attention(q, ck, ck, pt, qpos)
        torch.cuda.synchronize()
        key = ("paged_decode_attention", "ffma")
        assert ba.LAUNCHES_BY_DESIGN[key] == before[key] + 1
        with pytest.raises(ValueError, match="design"):
            ba.paged_decode_attention(q, ck, ck, pt, qpos, design="split")


# ------------------------------------- B5 / B5q design 2 ("split")
def _slot_case(device, cdtype, L, hkv, dh, seed, S=8, H=8, rolling=False):
    """q, caches, scale rows, and positions over the whole cache, first
    and last included (on the ring: before, at and well past its length,
    so it wraps)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(S, H, dh, generator=g).to(device)
    ck, sk = _pages(g, (S, L, hkv, dh), cdtype, device)
    cv, sv = _pages(g, (S, L, hkv, dh), cdtype, device)
    if rolling:
        qpos = torch.tensor([0, 5, L // 8, L // 2, L - 1, L, 2 * L - 7,
                             5 * L + 3])[:S]
    else:
        qpos = torch.linspace(0, L - 1, S).round().long()
    return q, ck, cv, sk, sv, qpos.to(device, torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("mode,window,rolling",
                         [("linear", None, False), ("window", 200, False),
                          ("rolling", 256, True), ("rolling_wide", 1500,
                                                   True)],
                         ids=["linear", "window", "rolling", "rolling_wide"])
@pytest.mark.parametrize("hkv", [8, 2])
@pytest.mark.parametrize("cdtype", B6_CACHES, ids=["f32", "int8", "fp8"])
def test_cuda_b5_split_matches_plain(cuda_device, cdtype, hkv, mode, window,
                                     rolling, dh):
    """Design 2 of B5 (float32 caches) and B5q (int8, e4m3) against the
    plain version at the B5/B5q tolerance (2e-5): chunks wholly past a
    short range, a ring read across its wrap (a window of 1500 on a ring
    of 1031: chunks of positions that wrap the ring), the launch counted
    under "split" with more than one split a slot."""
    L = 1031 if rolling else 1024
    q, ck, cv, sk, sv, qpos = _slot_case(cuda_device, cdtype, L, hkv, dh,
                                         hkv + dh + (window or 0),
                                         rolling=rolling)
    name = "banded_decode_attention" + ("" if sk is None else "_q")
    assert ba.b5_design(q.dtype, ck.dtype, 8, hkv, dh, (ck, cv)) == "split"
    assert ba.b5_splits(8, hkv, L, window, ba._sm_count(q.device),
                        ba.split_tile_keys(dh, ck.dtype))[1] > 1
    before = dict(ba.LAUNCHES_BY_DESIGN)
    out = ba.banded_decode_attention(q, ck, cv, qpos, qpos, window=window,
                                     rolling=rolling, scale_k=sk, scale_v=sv)
    ref = ba.decode_attention_plain(q, ck, cv, qpos, qpos, window=window,
                                    rolling=rolling, scale_k=sk, scale_v=sv)
    torch.cuda.synchronize()
    assert ba.LAUNCHES_BY_DESIGN[(name, "split")] == \
        before[(name, "split")] + 1
    assert ba.LAUNCHES_BY_DESIGN[(name, "ffma")] == before[(name, "ffma")]
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", B6_CACHES, ids=["f32", "int8", "fp8"])
def test_cuda_b5_split_is_bit_equal_and_design_1_agrees(cuda_device, cdtype):
    """At Path B's shape (S 8, H 8, Hkv 2, Dh 64, a ring of 2303, window
    256): two launches of design 2 give the same bits, and design 1 on the
    same inputs agrees within 2e-5; `end` ahead of `qpos` as a prefill
    chunk's first query sees it."""
    q, ck, cv, sk, sv, qpos = _slot_case(cuda_device, cdtype, 2303, 2, 64,
                                         41, rolling=True)
    end = qpos + torch.tensor([0, 3, 0, 7, 0, 0, 100, 0],
                              dtype=torch.int32, device=cuda_device)
    outs = [ba.banded_decode_attention(q, ck, cv, qpos, end, window=256,
                                       rolling=True, scale_k=sk, scale_v=sv,
                                       design=d)
            for d in ("split", "split", "ffma")]
    ref = ba.decode_attention_plain(q, ck, cv, qpos, end, window=256,
                                    rolling=True, scale_k=sk, scale_v=sv)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert (outs[0] - outs[2]).abs().max().item() <= 2e-5
    assert (outs[0] - ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", B6_CACHES, ids=["f32", "int8", "fp8"])
def test_cuda_b5_split_nan_query_and_empty_rows(cuda_device, cdtype):
    """`test_cuda_nan_query_and_empty_rows` on both designs over float32,
    int8 and e4m3 caches: a NaN query comes out NaN, a lane with no
    visible key (end = -1 on the ring) as zeros."""
    q, ck, cv, sk, sv, _ = _slot_case(cuda_device, cdtype, 300, 2, 64, 9,
                                      S=3)
    q[1] = float("nan")
    qpos = torch.tensor([250, 7, 0], dtype=torch.int32, device=cuda_device)
    end = torch.tensor([250, 7, -1], dtype=torch.int32, device=cuda_device)
    for d in ba.DESIGNS:
        out = ba.banded_decode_attention(q, ck, cv, qpos, end, window=200,
                                         rolling=True, scale_k=sk,
                                         scale_v=sv, design=d)
        torch.cuda.synchronize()
        assert torch.isfinite(out[0]).all()
        assert torch.isnan(out[1]).all()
        assert torch.equal(out[2], torch.zeros_like(out[2]))


@pytest.mark.cuda
def test_cuda_b5_bf16_and_other_head_dims_take_design_1(cuda_device):
    """bfloat16 caches (C6b) and head dims other than 64 and 128 are
    counted under design 1; design 2 refuses them when named."""
    g = torch.Generator().manual_seed(8)
    for dtype, dh in ((torch.bfloat16, 64), (torch.float32, 80),
                      (torch.float32, 32)):
        q = torch.randn(2, 8, dh, generator=g).to(cuda_device, dtype)
        ck = torch.randn(2, 40, 2, dh, generator=g).to(cuda_device, dtype)
        qpos = torch.tensor([3, 30], dtype=torch.int32, device=cuda_device)
        before = dict(ba.LAUNCHES_BY_DESIGN)
        ba.banded_decode_attention(q, ck, ck, qpos, qpos, window=16)
        torch.cuda.synchronize()
        key = ("banded_decode_attention", "ffma")
        assert ba.LAUNCHES_BY_DESIGN[key] == before[key] + 1
        with pytest.raises(ValueError, match="design"):
            ba.banded_decode_attention(q, ck, ck, qpos, qpos, window=16,
                                       design="split")


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


# every case in each design that takes it (`b4_design`: float32 at Dh
# 32/64/128 also on "folded")
B4_DESIGN_CASES = [c + (d,) for c in BANDED_CASES for d in ba.B4_DESIGNS
                   if d == "ffma" or ba.b4_design(c[7], c[2], c[3], c[4])
                   == "folded"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hkv,dh,w,causal,dtype,design",
                         B4_DESIGN_CASES)
def test_cuda_b4_matches_plain(cuda_device, b, t, h, hkv, dh, w, causal,
                               dtype, design):
    q, k, v, _ = _banded_inputs(b, t, h, hkv, dh, dtype, cuda_device,
                                t + w)
    before = dict(ba.LAUNCHES_BY_DESIGN)
    o = ba.banded_attention_fwd(q, k, v, w, causal, design=design)
    # bfloat16 rounds p against the running max of the kernel's key tile
    ref = ba.banded_reference(q, k, v, w, causal, block_k=ba.BAND_TILE)
    torch.cuda.synchronize()
    key = ("banded_attention", design)
    assert ba.LAUNCHES_BY_DESIGN[key] == before[key] + 1
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


# design 2 of B4 by group and head dim: path_w's shape cut in T, every
# group and head dim it takes, ragged T, a window past T, bidirectional
B4_FOLDED_CASES = [
    # (B, T, H, Hkv, Dh, window, causal)
    (2, 512, 8, 2, 64, 256, True),       # path_w's widths, T cut
    (1, 300, 8, 8, 64, 40, True),        # G 1: 128 positions a block
    (2, 301, 8, 4, 32, 77, True),        # G 2, Dh 32, ragged T
    (1, 200, 8, 1, 128, 63, False),      # G 8, Dh 128, bidirectional
    (2, 90, 4, 1, 64, 500, True),        # window past T, G 4
    (1, 64, 4, 4, 64, 1, True),          # window 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hkv,dh,w,causal", B4_FOLDED_CASES)
def test_cuda_b4_takes_the_folded_design(cuda_device, b, t, h, hkv, dh, w,
                                         causal):
    """float32 B4 at Dh 32/64/128 and G 1/2/4/8 runs on design 2 (counted
    under "folded"), within 2e-5 of the plain version and bit-equal over
    two launches; design 1 on the same inputs agrees within 2e-5."""
    q, k, v, _ = _banded_inputs(b, t, h, hkv, dh, torch.float32,
                                cuda_device, t * 7 + w)
    before = dict(ba.LAUNCHES_BY_DESIGN)
    o1, o2 = (ba.banded_attention_fwd(q, k, v, w, causal) for _ in range(2))
    one = ba.banded_attention_fwd(q, k, v, w, causal, design="ffma")
    ref = ba.banded_reference(q, k, v, w, causal)
    torch.cuda.synchronize()
    key = ("banded_attention", "folded")
    assert ba.LAUNCHES_BY_DESIGN[key] == before[key] + 2
    assert torch.equal(o1, o2)
    assert (o1 - ref).abs().max().item() <= 2e-5
    assert (o1 - one).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_cuda_b4_bf16_and_other_shapes_take_design_1(cuda_device):
    """bfloat16 (C6: design 1's 64-key tiles round p), head dims other
    than 32/64/128 and groups other than 1/2/4/8 are counted under design
    1; design 2 refuses them when named."""
    for dtype, h, hkv, dh in ((torch.bfloat16, 8, 2, 64),
                              (torch.float32, 4, 1, 48),
                              (torch.float32, 6, 2, 64)):
        q, k, v, _ = _banded_inputs(2, 100, h, hkv, dh, dtype, cuda_device,
                                    dh)
        before = dict(ba.LAUNCHES_BY_DESIGN)
        ba.banded_attention_fwd(q, k, v, 20, True)
        torch.cuda.synchronize()
        key = ("banded_attention", "ffma")
        assert ba.LAUNCHES_BY_DESIGN[key] == before[key] + 1
        with pytest.raises(ValueError, match="design"):
            ba.banded_attention_fwd(q, k, v, 20, True, design="folded")


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


# --------------------------------- B5 at a lockstep (0-d) position
@pytest.mark.cuda
@pytest.mark.parametrize("design", ["ffma", "split"])
@pytest.mark.parametrize("hkv,window,rolling", [(8, None, False),
                                                (2, 256, True)],
                         ids=["linear", "ring"])
def test_cuda_b5_at_a_broadcast_lockstep_position(cuda_device, hkv, window,
                                                  rolling, design):
    """A lockstep carry's 0-d position broadcast to every slot (the
    `rnn_time_step` path): both designs against the plain version (design
    2's in its own split order), 2e-5 in float32."""
    g = torch.Generator().manual_seed(21)
    S, H, Dh = 8, 8, 64
    L = 2303 if rolling else 2048
    q = torch.randn(S, H, Dh, generator=g).to(cuda_device)
    ck = torch.randn(S, L, hkv, Dh, generator=g).to(cuda_device)
    cv = torch.randn(S, L, hkv, Dh, generator=g).to(cuda_device)
    pos = torch.tensor(3000 if rolling else 1500, dtype=torch.int32,
                       device=cuda_device)
    qpos = pos.expand(S).contiguous()
    before = dict(ba.LAUNCHES_BY_DESIGN)
    o = ba.banded_decode_attention(q, ck, cv, qpos, qpos, window=window,
                                   rolling=rolling, design=design)
    kw = {}
    if design == "split":
        c, _ = ba.b5_splits(S, hkv, L, window, ba._sm_count(q.device),
                            ba.split_tile_keys(Dh, ck.dtype))
        kw = dict(split_keys=c)
    ref = ba.decode_attention_plain(q, ck, cv, qpos, qpos, window, rolling,
                                    **kw)
    torch.cuda.synchronize()
    key = ("banded_decode_attention", design)
    assert ba.LAUNCHES_BY_DESIGN[key] == before[key] + 1
    assert (o - ref).abs().max().item() <= 2e-5


# ---------------------------------------------------- slice 17 (A1b)
@pytest.mark.cuda
@pytest.mark.parametrize("updater", ["adam", "nesterovs"])
def test_cuda_pretrain_launches_one_fused_update_a_step(cuda_device,
                                                        updater,
                                                        monkeypatch):
    """`pretrain` under Adam (B1a) or Nesterovs (B1b): one launch a
    pretrain step, over the pretrained layer's leaves alone (a frozen
    AutoEncoder is skipped, the output layer untouched)."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        RBM, AutoEncoder, FrozenLayer, OutputLayer,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs

    upd = Adam(1e-2) if updater == "adam" else Nesterovs(0.1, 0.9)
    kernel = "adam_update" if updater == "adam" else "nesterov_update"
    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(3).updater(upd)
        .activation("sigmoid")
        .list(FrozenLayer(layer=AutoEncoder(n_out=8)),
              AutoEncoder(n_out=6, corruption_level=0.2), RBM(n_out=5),
              OutputLayer(n_out=3, activation="softmax"))
        .set_input_type(InputType.feed_forward(10)).build(),
        device=cuda_device).init()
    names = [l.name for l in net.conf.layers]
    before = {n: {k: v.clone() for k, v in net.params_tree[n].items()}
              for n in names}
    seen = []
    launch = getattr(fu, kernel)

    def record(params, *rest, **kw):
        seen.append({p.data_ptr() for p in params})
        return launch(params, *rest, **kw)

    monkeypatch.setattr(fu, kernel, record)
    fu.reset_counts()
    x = torch.rand(32, 10, generator=torch.Generator().manual_seed(0))
    net.pretrain(x.numpy(), epochs=1, batch_size=8)
    torch.cuda.synchronize()
    assert fu.LAUNCHES[kernel] == 8 and sum(fu.PLAIN_ON_CUDA.values()) == 0
    other = "nesterov_update" if updater == "adam" else "adam_update"
    assert fu.LAUNCHES[other] == 0
    leaves = {n: {v.data_ptr() for v in net.params_tree[n].values()}
              for n in names}
    assert seen == [leaves[names[1]]] * 4 + [leaves[names[2]]] * 4
    for n in (names[0], names[3]):
        for k, v in net.params_tree[n].items():
            assert torch.equal(v, before[n][k]), f"{n}/{k}"
    for n in names[1:3]:
        assert not torch.equal(net.params_tree[n]["W"], before[n]["W"])


@pytest.mark.cuda
def test_cuda_async_iterator_feeds_a_captured_fit(cuda_device):
    """`AsyncDataSetIterator` under `fit(steps_per_dispatch=4)`: its pump
    thread makes no CUDA call, so the window is captured and replayed
    (window 1 eager, then one capture, two replays) and the weights
    equal the bare iterator's fit bit for bit."""
    import numpy as np

    from deeplearning4j_tpu_torch.data import (
        ArrayDataSetIterator, AsyncDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(4).updater(Adam(1e-2))
            .list(DenseLayer(n_out=32, activation="tanh"),
                  OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.feed_forward(16)).build())
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    nets = []
    for wrap in (lambda b: b, lambda b: AsyncDataSetIterator(b, 2)):
        net = MultiLayerNetwork(conf, device=cuda_device).init()
        it = wrap(ArrayDataSetIterator(x, y, 16))
        fu.reset_counts()
        net.fit(it, epochs=3, steps_per_dispatch=4)
        torch.cuda.synchronize()
        if isinstance(it, AsyncDataSetIterator):
            it.close()
        assert net.fit_stats == {"graph_windows": 2, "eager_steps": 4}
        assert net._graphs.stats["fit"]["captures"] == 1
        assert fu.LAUNCHES["adam_update"] == 12
        nets.append(net)
    assert torch.equal(nets[0].params(), nets[1].params())
