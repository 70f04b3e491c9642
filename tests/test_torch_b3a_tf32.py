"""Design 3 of the float32 flash forward B3a ("tf32x3": S = Q·K^T and P·V
on the tensor cores as three TF32 products, the online softmax in
registers) on the CPU: the design rule, the plain forward with its
products split that way against the JAX package's Pallas forward in
interpret mode, the numeric guard that tells 3xTF32 from a one-pass TF32
product on o and on lse, and that a failing launch raises instead of
falling back. The kernel itself runs only on a card
(`tests/test_torch_cuda_kernels.py`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.attention import _run_flash
from deeplearning4j_tpu_torch.ops import attention as fa
from deeplearning4j_tpu_torch.ops import cuda_build

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(dtype, dh, offset=0, bh=2, tq=100, tk=77):
    buf = torch.zeros(offset + bh * tq * dh, dtype=dtype)
    q = buf[offset:].view(bh, tq, dh)
    k, v = (torch.zeros(bh, tk, dh, dtype=dtype) for _ in range(2))
    return q, k, v


# ------------------------------------------------------------ design rule
@pytest.mark.parametrize("dtype,dh,offset,want", [
    (torch.float32, 64, 0, "tf32x3"),     # path_t's and path_x's forward
    (torch.float32, 128, 0, "tf32x3"),
    (torch.float32, 32, 0, "ffma"),       # no 64-wide tile
    (torch.float32, 48, 0, "ffma"),
    (torch.float32, 64, 2, "ffma"),       # q 8 bytes into its storage
    (torch.bfloat16, 64, 0, "wgmma"),     # bfloat16 stays on design 2
    (torch.bfloat16, 64, 4, "ffma"),
])
def test_b3_design_sends_the_float32_forward_to_tf32x3(dtype, dh, offset,
                                                       want):
    assert fa.b3_design(dtype, dh, _qkv(dtype, dh, offset)) == want


@pytest.mark.parametrize("which", [1, 2])
def test_every_forward_operand_is_held_to_16_byte_alignment(which):
    """k and v (read by 16-byte copies) count as q does."""
    ops = list(_qkv(torch.float32, 64))
    buf = torch.zeros(1 + 2 * 77 * 64)
    ops[which] = buf[1:].view(2, 77, 64)
    assert fa.b3_design(torch.float32, 64, ops) == "ffma"


def test_forward_entry_point_and_count():
    assert ("flash_attention_fwd", "tf32x3") in fa.LAUNCHES_BY_DESIGN
    assert "dl4j_flash_fwd_tf32x3" in cuda_build.SOURCES["flash_attention"]


# --------------------------------------- the split plain forward vs JAX
def _inputs(tq, tk, seed, bh=3, d=8):
    rng = np.random.default_rng(seed)
    mk = lambda t: rng.standard_normal((bh, t, d)).astype(np.float32)  # noqa
    return mk(tq), mk(tk), mk(tk)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("tq,tk,causal", [(16, 16, True), (16, 16, False),
                                          (16, 24, False), (24, 8, False)])
def test_tf32x3_plain_forward_matches_pallas(tq, tk, causal):
    """o and lse of the plain forward with its two products taken as
    3xTF32 against the Pallas forward in interpret mode, within 1e-5
    absolute and relative (float32 sums in another order)."""
    q, k, v = _inputs(tq, tk, 7 * tq + tk)
    scale = 8 ** -0.5
    want_o, want_lse = _run_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, scale=scale,
                                  block_q=8, block_k=8, interpret=True,
                                  with_lse=True)
    o, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), causal,
                                      products="tf32x3")
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_forward_products_emulate_float32_only():
    q = torch.zeros(1, 8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention_plain(q, q, q, True, products="tf32x3")
    with pytest.raises(ValueError, match="products"):
        fa.flash_attention_plain(q.float(), q.float(), q.float(), True,
                                 products="tf16")


# ------------------------------------------------------------ the guard
def guard_errors(q, k, v, causal):
    """{products: (o, lse) largest error against the float64 plain
    forward on the same float32 inputs, each a share of the largest
    |ref|} for the plain float32 products (None), 3xTF32 and one-pass
    TF32."""
    ref = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                   causal)
    out = {}
    for products in (None, "tf32x3", "tf32"):
        got = fa.flash_attention_plain(q, k, v, causal, products=products)
        out[products] = [((g.double() - r).abs().max()
                          / r.abs().max()).item()
                         for g, r in zip(got, ref)]
    return out


@pytest.mark.parametrize("bh,tq,tk,dh,causal", [(2, 256, 256, 64, True),
                                                (2, 300, 300, 64, True),
                                                (2, 256, 128, 64, False),
                                                (2, 128, 128, 128, False)])
def test_guard_passes_3xtf32_and_fails_one_pass_tf32(bh, tq, tk, dh,
                                                     causal):
    """The card tests hold design 3's forward to at most twice design 1's
    error against float64 on the same inputs, on o and on lse (the
    backward rebuilds p from lse, so lse is held too). Emulated here:
    3xTF32 stays within twice float32's error, and one-pass TF32 misses
    that by at least 10x, so the guard tells the two apart."""
    g = torch.Generator().manual_seed(tq + tk + dh)
    q = torch.randn(bh, tq, dh, generator=g)
    k, v = (torch.randn(bh, tk, dh, generator=g) for _ in range(2))
    errs = guard_errors(q, k, v, causal)
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
    goes to `library`, and the plain forward must not be reached."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain forward was reached")

    monkeypatch.setattr(fa, "_on_card", lambda q: True)
    monkeypatch.setattr(fa, "_check_cuda", lambda tensors, dtype: None)
    monkeypatch.setattr(fa, "_stream", lambda dev: None)
    monkeypatch.setattr(fa, "flash_attention_plain", plain)
    monkeypatch.setattr(cuda_build, "library", library)


@pytest.mark.parametrize("dh,with_lse", [(64, True), (128, True),
                                         (64, False)])
def test_a_failing_tf32x3_forward_raises_without_falling_back(monkeypatch,
                                                              dh, with_lse):
    lib = _FailingLibrary()
    _route_as_on_a_card(monkeypatch, lambda name: lib)
    fa.reset_counts()
    g = torch.Generator().manual_seed(dh)
    q, k, v = (torch.randn(2, 70, dh, generator=g) for _ in range(3))
    with pytest.raises(RuntimeError, match=r"tf32x3.*CUDA error 719"):
        fa.flash_attention_fwd(q, k, v, True, with_lse=with_lse)
    assert lib.calls == ["dl4j_flash_fwd_tf32x3"]
    assert set(fa.LAUNCHES_BY_DESIGN.values()) == {0}


def test_a_failing_forward_build_raises_without_falling_back(monkeypatch):
    def library(name):
        raise RuntimeError("nvcc failed for flash_attention")

    _route_as_on_a_card(monkeypatch, library)
    q, k, v = (torch.ones(1, 64, 64) for _ in range(3))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa.flash_attention_fwd(q, k, v, False)
