"""Design 3 of the float32 flash backward B3b/B3c ("tf32x3": the products
on the tensor cores as three TF32 products) on the CPU: the design rule,
the split each float32 operand takes (`tf32x3_split`), the plain backward
with its products split that way against the JAX package's Pallas
backward in interpret mode, the numeric guard that tells 3xTF32 from a
one-pass TF32 product, and that a failing launch raises instead of
falling back. The kernels themselves run only on a card
(`tests/test_torch_cuda_kernels.py`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.attention import _run_flash, _run_flash_bwd
from deeplearning4j_tpu_torch.ops import attention as fa
from deeplearning4j_tpu_torch.ops import cuda_build

TOL = dict(atol=1e-5, rtol=1e-5)


def _operands(dtype, dh, offset=0, bh=2, t=100):
    buf = torch.zeros(offset + bh * t * dh, dtype=dtype)
    q = buf[offset:].view(bh, t, dh)
    k, v, do = (torch.zeros(bh, t, dh, dtype=dtype) for _ in range(3))
    return q, k, v, do


# ------------------------------------------------------------ design rule
@pytest.mark.parametrize("dtype,dh,offset,backward,want", [
    (torch.float32, 64, 0, True, "tf32x3"),     # path_t's backward
    (torch.float32, 128, 0, True, "tf32x3"),
    (torch.float32, 32, 0, True, "ffma"),       # no 64-wide tile
    (torch.float32, 48, 0, True, "ffma"),
    (torch.float32, 64, 2, True, "ffma"),       # q 8 bytes into storage
    (torch.float32, 64, 0, False, "tf32x3"),    # the forward too
    (torch.float32, 128, 0, False, "tf32x3"),
    (torch.bfloat16, 64, 0, True, "wgmma"),     # bfloat16 unchanged
    (torch.bfloat16, 64, 0, False, "wgmma"),
    (torch.bfloat16, 32, 0, True, "ffma"),
])
def test_b3_design_sends_the_float32_backward_to_tf32x3(dtype, dh, offset,
                                                        backward, want):
    ops = _operands(dtype, dh, offset)
    assert fa.b3_design(dtype, dh, ops if backward else ops[:3]) == want


def test_every_operand_is_held_to_16_byte_alignment():
    """dO (read by 16-byte copies in both kernels) counts as q does."""
    q, k, v, _ = _operands(torch.float32, 64)
    buf = torch.zeros(1 + 2 * 100 * 64)
    do = buf[1:].view(2, 100, 64)
    assert fa.b3_design(torch.float32, 64, (q, k, v, do)) == "ffma"


def test_designs_and_entry_points():
    assert "tf32x3" in fa.DESIGNS
    for kern in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        assert (kern, "tf32x3") in fa.LAUNCHES_BY_DESIGN
        entry = fa._BWD_ENTRY[kern]["tf32x3"]
        assert entry in cuda_build.SOURCES["flash_attention"]


# ------------------------------------------------------------- the split
def test_split_rebuilds_x_within_2_to_the_minus_22():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(200_000, generator=g) * torch.exp(
        torch.randn(200_000, generator=g) * 8)
    big, small = fa.tf32x3_split(x)
    for part in (big, small):   # both TF32: 13 low bits clear
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (big + small - x).abs()
    assert bool((err <= 2.0 ** -22 * x.abs()).all())
    # big alone, the one-pass operand, keeps about 11 bits
    assert (big - x).abs().div(x.abs()).max().item() > 2.0 ** -13


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split_rounds_to_nearest_with_ties_away_from_zero(sign):
    ulp = 2.0 ** -10                # TF32's unit at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23,
                      1 + 1.5 * ulp, 1 + ulp / 4]) * sign
    want = torch.tensor([1 + ulp, 1.0, 1 + 2 * ulp, 1.0]) * sign
    assert torch.equal(fa.tf32_rna(x), want)
    big, small = fa.tf32x3_split(x)
    assert bool(((big + small - x).abs() <= 2.0 ** -22 * x.abs()).all())


# ---------------------------------- the split plain backward against JAX
def _inputs(tq, tk, seed, bh=3, d=8):
    rng = np.random.default_rng(seed)
    mk = lambda t: rng.standard_normal((bh, t, d)).astype(np.float32)  # noqa
    return mk(tq), mk(tk), mk(tk), mk(tq)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("tq,tk,causal", [(16, 16, True), (16, 16, False),
                                          (16, 24, False)])
def test_tf32x3_plain_backward_matches_pallas(tq, tk, causal):
    q, k, v, do = _inputs(tq, tk, 5 * tq + tk)
    scale = 8 ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = _run_flash(jq, jk, jv, causal=causal, scale=scale, block_q=8,
                        block_k=8, interpret=True, with_lse=True)
    want = _run_flash_bwd(jq, jk, jv, o, lse, jdo, causal=causal,
                          scale=scale, block_q=8, block_k=8,
                          interpret=True)
    got = fa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(o), _t(lse),
                                       _t(do), causal, products="tf32x3")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_products_emulate_float32_only():
    q = torch.zeros(1, 8, 8, dtype=torch.float64)
    lse = torch.zeros(1, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention_bwd_plain(q, q, q, q, lse, q, True,
                                     products="tf32x3")
    with pytest.raises(ValueError, match="products"):
        fa.flash_attention_bwd_plain(q.float(), q.float(), q.float(),
                                     q.float(), lse.float(), q.float(),
                                     True, products="tf16")


# ------------------------------------------------------------ the guard
def guard_errors(q, k, v, o, lse, do, causal):
    """{products: [dq, dk, dv] largest error against the float64 plain
    backward on the same float32 inputs, each a share of the largest
    |ref|} for the plain float32 products (None), 3xTF32 and one-pass
    TF32."""
    ref = fa.flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, o, lse, do)), causal)
    out = {}
    for products in (None, "tf32x3", "tf32"):
        got = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                           products=products)
        out[products] = [((g.double() - r).abs().max()
                          / r.abs().max()).item()
                         for g, r in zip(got, ref)]
    return out


@pytest.mark.parametrize("bh,t,dh,causal", [(2, 256, 64, True),
                                            (2, 300, 64, True),
                                            (2, 128, 128, False)])
def test_guard_passes_3xtf32_and_fails_one_pass_tf32(bh, t, dh, causal):
    """The card tests hold design 3 to at most twice design 1's error
    against float64 on the same inputs. Emulated here: 3xTF32 stays
    within that (1.0-1.5x of float32's error on a CPU), and one-pass TF32
    misses it by far (about 1000x), so the guard tells the two apart."""
    g = torch.Generator().manual_seed(t + dh)
    q, k, v, do = (torch.randn(bh, t, dh, generator=g) for _ in range(4))
    o, lse = fa.flash_attention_plain(q, k, v, causal)
    errs = guard_errors(q, k, v, o, lse, do, causal)
    for exact, x3, x1 in zip(errs[None], errs["tf32x3"], errs["tf32"]):
        assert 0 < exact < 1e-5
        assert x3 <= 2 * exact
        assert x1 >= 10 * 2 * exact


# --------------------------------------------------------- no fallback
class _FailingLibrary:
    """Stands in for the built library: every launch returns a CUDA
    error (719, a launch failure) and is recorded."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return 719
        return launch

    def dl4j_cuda_error_string(self, rc):
        return b"unspecified launch failure"


def _route_as_on_a_card(monkeypatch, library):
    """Make the wrapper treat CPU tensors as a card's: what it launches
    goes to `library`, and the plain version must not be reached."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain backward was reached")

    monkeypatch.setattr(fa, "_on_card", lambda q: True)
    monkeypatch.setattr(fa, "_check_cuda", lambda tensors, dtype: None)
    monkeypatch.setattr(fa, "_stream", lambda dev: None)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", plain)
    monkeypatch.setattr(cuda_build, "library", library)


@pytest.mark.parametrize("dh", [64, 128])
def test_a_failing_tf32x3_launch_raises_without_falling_back(monkeypatch,
                                                             dh):
    lib = _FailingLibrary()
    _route_as_on_a_card(monkeypatch, lambda name: lib)
    fa.reset_counts()
    g = torch.Generator().manual_seed(dh)
    q, k, v, o, do = (torch.randn(2, 70, dh, generator=g) for _ in range(5))
    lse = torch.zeros(2, 70)
    with pytest.raises(RuntimeError, match=r"tf32x3.*CUDA error 719"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    assert lib.calls == ["dl4j_flash_bwd_dkdv_tf32x3"]
    assert set(fa.LAUNCHES_BY_DESIGN.values()) == {0}


def test_a_failing_build_raises_without_falling_back(monkeypatch):
    def library(name):
        raise RuntimeError("nvcc failed for flash_attention")

    _route_as_on_a_card(monkeypatch, library)
    q, k, v, o, do = (torch.ones(1, 64, 64) for _ in range(5))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa.flash_attention_bwd(q, k, v, o, torch.zeros(1, 64), do, False)
