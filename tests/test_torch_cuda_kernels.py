"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the decode kernels B5 and B6, the flash-attention forward B3a and
backward B3b/B3c, and the fused Adam B1a. These tests import only torch,
so they run on a machine with a card and no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Where there is no card they skip (the kernels are CUDA C++ with no CPU
or interpret mode; their plain versions are held against the JAX
package in `tests/test_torch_decode_attention.py`,
`test_torch_flash_attention.py` and `test_torch_fused_update.py`).
Tolerances, in the working dtype: 2e-5 absolute in float32 on attention
outputs and lse, 1e-4 of the reference's largest magnitude on attention
gradients (sums of up to T products taken in another order); in
bfloat16 one bf16 step of the reference (2**-7 of its value, plus 1e-5),
since the kernel and the plain version both compute in float32 and
round once. The fused Adam kernel rounds every operation as the plain
version's elementwise ops do, so it is held to 2**-22 relative (two
float32 ulps) and, in bfloat16, one bf16 step."""

import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as fa
from deeplearning4j_tpu_torch.ops import banded_attention as ba
from deeplearning4j_tpu_torch.ops import fused_update as fu

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
