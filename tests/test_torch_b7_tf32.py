"""Design 3 of the float32 conv+BN statistics kernels B7a/B7b ("tf32x3":
the products on the tensor cores as three TF32 products) on the CPU: the
design rule, the tile and ring sizing against a block's shared memory,
the plain versions with their products split as design 3 splits them
against the JAX package's Pallas kernels in interpret mode, the numeric
guard that tells 3xTF32 from a one-pass TF32 product at the deepest K of
ResNet-50, and that a failing launch or build raises instead of falling
back. The kernels themselves run only on a card
(`tests/test_torch_cuda_kernels.py`).

Tolerances: y within 1e-5 of its largest magnitude and the statistics
within 1e-5 relative of the largest (K products and M values summed in
another order; 3xTF32 keeps about 22 bits of each operand)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops import conv_fused as jcf
from deeplearning4j_tpu_torch.ops import attention as fa
from deeplearning4j_tpu_torch.ops import conv_fused as cf
from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.ops import tf32

ALIGNED = (0, 256)


# ------------------------------------------------------------ design rule
@pytest.mark.parametrize("dtype,shape,ptrs,want", [
    (torch.float32, (401408, 64, 256), ALIGNED, "tf32x3"),   # path_r 1x1s
    (torch.float32, (6272, 2048, 512), ALIGNED, "tf32x3"),
    (torch.float32, (128, 56, 56, 64, 64), ALIGNED, "tf32x3"),  # 3x3s
    (torch.float32, (128, 7, 7, 512, 512), ALIGNED, "tf32x3"),
    (torch.float32, (1000, 40, 136), ALIGNED, "tf32x3"),   # ragged M, N
    (torch.float32, (2, 5, 6, 4, 12), ALIGNED, "tf32x3"),   # C 4
    (torch.float32, (1000, 37, 130), ALIGNED, "ffma"),     # K off 4
    (torch.float32, (129, 20, 66), ALIGNED, "ffma"),       # N off 4
    (torch.float32, (2, 5, 6, 3, 4), ALIGNED, "ffma"),     # C 3
    (torch.float32, (3136, 64, 256), (8, 256), "ffma"),    # x off 16 bytes
    (torch.float32, (3136, 64, 256), (0, 260), "ffma"),    # w off 16 bytes
    (torch.bfloat16, (401408, 64, 256), ALIGNED, "wgmma"),  # bf16 unchanged
    (torch.bfloat16, (1000, 40, 136), ALIGNED, "wgmma"),
    (torch.bfloat16, (1000, 36, 136), ALIGNED, "ffma"),
    (torch.float32, (2, 9, 64, 64, 64), ALIGNED, "ffma"),  # W past 63
    (torch.bfloat16, (2, 9, 64, 64, 64), ALIGNED, "wgmma"),
])
def test_b7_design_sends_aligned_float32_to_tf32x3(dtype, shape, ptrs,
                                                   want):
    assert cf.b7_design(dtype, shape, ptrs) == want


def test_every_path_r_shape_takes_tf32x3_in_float32():
    import chip_smoke

    for _, shape in chip_smoke.b7_path_shapes():
        assert cf.b7_design(torch.float32, shape, ALIGNED) == "tf32x3"


def test_designs_and_entry_points():
    assert "tf32x3" in cf.DESIGNS
    for kern, c_name in cf._C_NAMES.items():
        assert (kern, "tf32x3") in cf.LAUNCHES_BY_DESIGN
        assert f"{c_name}_tf32x3" in cuda_build.SOURCES["conv_fused"]


def test_the_split_is_shared_with_the_flash_kernels():
    """`ops/tf32.py` holds the split; `ops/attention` re-exports it."""
    assert fa.tf32_rna is tf32.tf32_rna
    assert fa.tf32x3_split is tf32.tf32x3_split
    x = torch.tensor([1 + 2.0 ** -11, -3.0 - 2.0 ** -10])
    big, small = tf32.tf32x3_split(x)
    assert torch.equal(big + small, x)


# ------------------------------------------------- tiles and shared memory
@pytest.mark.parametrize("shape,want", [
    ((401408, 64, 64), (64, 6)),
    ((401408, 64, 256), (128, 4)),
    ((6272, 2048, 512), (128, 4)),
    ((128, 14, 14, 256, 256), (128, 5)),
    ((128, 56, 56, 64, 64), (64, 6)),
    ((128, 28, 28, 128, 128), (128, 5)),
    ((128, 7, 7, 512, 512), (128, 5)),
    ((2, 5, 6, 4, 12), (64, 6)),
])
def test_tf32x3_tile_fits_a_block(shape, want):
    """BN 64 where N <= 64, else 128 (two 64 x BN float32 accumulators a
    warpgroup); as many stages as fit in 227 KB beside B7b's two x tiles
    with their halo, at most 6, never under 2 (a consumer gives a stage
    back after its products)."""
    bn, stages = cf.tf32x3_tile(shape)
    assert (bn, stages) == want
    halo_w = shape[2] if len(shape) == 5 else None
    assert cf.tf32x3_smem(bn, stages, halo_w) <= cf.SMEM_BYTES
    assert stages == 6 or \
        cf.tf32x3_smem(bn, stages + 1, halo_w) > cf.SMEM_BYTES


@pytest.mark.parametrize("width,want", [(7, "tf32x3"), (56, "tf32x3"),
                                        (63, "tf32x3"), (64, "ffma"),
                                        (112, "ffma")])
def test_float32_b7b_maps_route_by_width(width, want):
    """Design 3 stages a B7b tile's rows with their halo, 128 + 2 W + 2,
    as one TMA box of at most 256 rows: W <= 63 (`TF32_HALO_MAX_W`), so
    wider float32 maps take design 1; bfloat16 is not affected."""
    shape = (2, 9, width, 64, 64)
    assert cf.b7_design(torch.float32, shape, ALIGNED) == want
    assert (128 + 2 * width + 2 <= 256) == (want == "tf32x3")
    assert cf.b7_design(torch.bfloat16, shape, ALIGNED) == "wgmma"


# --------------------------------------------- the kernel's flush group
def test_flush_depth_is_the_kernels():
    """`TF32_FLUSH_DEPTH`, the depth of the CPU emulation's groups, is
    the kernel's kFlush k8 steps, read from its source."""
    import re

    src = (cuda_build.CSRC / "conv_fused.cu").read_text()
    found = re.findall(r"constexpr int kFlush = (\d+);", src)
    assert len(found) == 1
    assert cf.TF32_FLUSH_DEPTH == 8 * int(found[0])
    assert 32 % cf.TF32_FLUSH_DEPTH == 0


def _data(kernel, shape, kind, g):
    """float32 inputs: "ints" small integers, "onehot" one-hot rows of x
    with integer w (both exact in TF32), "relu" x = relu(N(0, 1))."""
    *lead, cin, n = shape
    kshape = (cin, n) if kernel == "conv1x1_bn_stats" else (3, 3, cin, n)
    if kind == "ints":
        return (torch.randint(-3, 4, (*lead, cin), generator=g).float(),
                torch.randint(-3, 4, kshape, generator=g).float())
    if kind == "onehot":
        hot = torch.randint(0, cin, tuple(lead), generator=g)
        return (torch.nn.functional.one_hot(hot, cin).float(),
                torch.randint(-8, 9, kshape, generator=g).float())
    fan = cin * (9 if kernel == "conv3x3_bn_stats" else 1)
    return (torch.relu(torch.randn(*lead, cin, generator=g)),
            torch.randn(*kshape, generator=g) / fan ** 0.5)


def _plain(kernel):
    return cf.matmul_with_channel_stats_plain \
        if kernel == "conv1x1_bn_stats" \
        else cf.conv3x3_with_channel_stats_plain


@pytest.mark.parametrize("kind", ["ints", "onehot"])
@pytest.mark.parametrize("kernel,shape", [
    ("conv1x1_bn_stats", (64, 2048, 64)),
    ("conv3x3_bn_stats", (1, 7, 7, 256, 64)),
])
def test_tf32_exact_data_is_exact_in_3xtf32(kernel, shape, kind):
    """On data exact in TF32 the split's small terms are zero and every
    sum is exact: 3xTF32 (and one-pass TF32) give the float64 product to
    the bit, as design 1 does. Design 3 adds nothing for the tensor
    cores' truncation, so the card tests hold it to the same."""
    x, w = _data(kernel, shape, kind, torch.Generator().manual_seed(5))
    assert torch.equal(tf32.tf32x3_split(x)[1], torch.zeros_like(x))
    ref = _plain(kernel)(x.double(), w.double())
    for products in ("tf32x3", "tf32"):
        got = _plain(kernel)(x, w, products=products)
        assert torch.equal(got[0].double(), ref[0])


@pytest.mark.parametrize("kernel,shape", [
    ("conv1x1_bn_stats", (64, 2048, 64)),
    ("conv3x3_bn_stats", (1, 7, 7, 256, 64)),
])
def test_3xtf32_keeps_22_bits_on_post_relu_inputs(kernel, shape):
    """Nonnegative x, as ResNet's activations after a ReLU, at K 2048 and
    9·C 2304: y, Σy and Σy² of 3xTF32 within 2^-20 of the largest |ref|
    against float64 (the split keeps about 22 bits of each operand, and
    the float32 sum of K / 8 groups rounds K / 8 times), one-pass TF32
    at least 30 times that. Not held to twice the CPU's exact float32
    error here: that product sums blocks far shorter than K, and w's
    rounding to two TF32 terms, the same for every row, adds up over the
    rows where x's mean is not zero (y and Σy² read up to 2.4x on these
    inputs). The card's guard holds design 3 to design 1's error, one
    FMA chain over K, on such inputs."""
    x, w = _data(kernel, shape, "relu", torch.Generator().manual_seed(7))
    errs = _guard(lambda p: _plain(kernel)(x, w, products=p),
                  lambda: _plain(kernel)(x.double(), w.double()))
    for x3, x1 in zip(errs["tf32x3"], errs["tf32"]):
        assert x3 <= 2.0 ** -20
        assert x1 >= 30 * 2.0 ** -20


# ------------------------------- the split plain versions against Pallas
def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, scale_of):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(scale_of).max(), 1.0))


@pytest.mark.parametrize("m,k,n", [(64, 64, 32), (256, 96, 128),
                                   (130, 20, 68)])
def test_tf32x3_plain_b7a_matches_pallas(m, k, n):
    """(130, 20, 68) does not tile: JAX takes its XLA fallback."""
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / k ** 0.5).astype(np.float32)
    want = jcf.matmul_with_channel_stats(jnp.asarray(x), jnp.asarray(w),
                                         interpret=True)
    got = cf.matmul_with_channel_stats_plain(_t(x), _t(w),
                                             products="tf32x3")
    _close(got[0], want[0], want[0])
    _close(got[1], want[1], want[1])
    _close(got[2], want[2], want[2])


@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 32), (3, 7, 7, 36, 12)])
def test_tf32x3_plain_b7b_matches_pallas(shape):
    """(3, 7, 7, 36, 12) does not tile: JAX takes its XLA fallback."""
    b, h, wd, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, h, wd, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout))
         / (9 * cin) ** 0.5).astype(np.float32)
    want = jcf.conv3x3_with_channel_stats(jnp.asarray(x), jnp.asarray(w),
                                          interpret=True)
    got = cf.conv3x3_with_channel_stats_plain(_t(x), _t(w),
                                              products="tf32x3")
    for g, w_ in zip(got, want):
        _close(g, w_, w_)


def test_products_emulate_float32_only():
    x = torch.zeros(8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        cf.matmul_with_channel_stats_plain(x, x, products="tf32x3")
    with pytest.raises(ValueError, match="products"):
        cf.conv3x3_with_channel_stats_plain(
            torch.zeros(1, 3, 3, 4), torch.zeros(3, 3, 4, 4),
            products="tf16")


# ------------------------------------------------------------ the guard
def _guard(run, run64):
    """{products: [y, Σy, Σy²] largest error against the float64 plain
    version on the same float32 inputs, each a share of the largest
    |ref|} for the exact float32 products (None), 3xTF32 and one-pass
    TF32."""
    ref = run64()
    out = {}
    for products in (None, "tf32x3", "tf32"):
        got = run(products)
        out[products] = [((g.double() - r).abs().max()
                          / r.abs().max()).item()
                         for g, r in zip(got, ref)]
    return out


@pytest.mark.parametrize("kernel,shape", [
    ("conv1x1_bn_stats", (64, 2048, 64)),      # ResNet-50's deepest 1x1
    ("conv3x3_bn_stats", (1, 7, 7, 256, 64)),  # 9·C 2304
])
def test_guard_passes_3xtf32_and_fails_one_pass_tf32(kernel, shape):
    """The card tests hold design 3 to at most twice design 1's error
    against float64 on the same inputs. Emulated here at K 2048 and
    9·C 2304: 3xTF32 stays within twice exact float32's error, and
    one-pass TF32 misses it by orders of magnitude (about 1000x), so
    the guard tells the two apart."""
    g = torch.Generator().manual_seed(sum(shape))
    if kernel == "conv1x1_bn_stats":
        m, k, n = shape
        x = torch.randn(m, k, generator=g)
        w = torch.randn(k, n, generator=g) / k ** 0.5
        plain = cf.matmul_with_channel_stats_plain
    else:
        b, h, wd, cin, n = shape
        x = torch.randn(b, h, wd, cin, generator=g)
        w = torch.randn(3, 3, cin, n, generator=g) / (9 * cin) ** 0.5
        plain = cf.conv3x3_with_channel_stats_plain
    errs = _guard(lambda p: plain(x, w, products=p),
                  lambda: plain(x.double(), w.double()))
    for exact, x3, x1 in zip(errs[None], errs["tf32x3"], errs["tf32"]):
        assert 0 < exact < 1e-5
        assert x3 <= 2 * exact
        assert x1 >= 100 * 2 * exact


# --------------------------------------------------------- no fallback
class _FailingLibrary:
    """Stands in for the built library: every launch returns a CUDA
    error (719, a launch failure) and is recorded."""

    def __init__(self):
        self.calls = []

    def dl4j_conv_stats_tile_m(self):
        return 128

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return 719
        return launch

    def dl4j_cuda_error_string(self, rc):
        return b"unspecified launch failure"


def _route_as_on_a_card(monkeypatch, library):
    """Make the wrappers treat CPU tensors as a card's: what they launch
    goes to `library`, and the plain versions must not be reached."""
    def plain(*args, **kwargs):
        raise AssertionError("a plain version was reached")

    monkeypatch.setattr(cf, "_on_card", lambda x: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(cf, "matmul_with_channel_stats_plain", plain)
    monkeypatch.setattr(cf, "conv3x3_with_channel_stats_plain", plain)
    monkeypatch.setattr(cuda_build, "library", library)


def _aligned(*shape):
    """A CPU tensor whose data starts on 16 bytes, as the allocator's."""
    n = int(np.prod(shape))
    buf = torch.randn(n + 4)
    off = (-buf.data_ptr() % 16) // 4
    return buf[off:off + n].view(*shape)


@pytest.mark.parametrize("kernel", ["conv1x1_bn_stats", "conv3x3_bn_stats"])
def test_a_failing_tf32x3_launch_raises_without_falling_back(monkeypatch,
                                                             kernel):
    lib = _FailingLibrary()
    _route_as_on_a_card(monkeypatch, lambda name: lib)
    cf.reset_counts()
    if kernel == "conv1x1_bn_stats":
        with pytest.raises(RuntimeError, match=r"tf32x3.*CUDA error 719"):
            cf.matmul_with_channel_stats(_aligned(300, 64), _aligned(64, 96))
        assert lib.calls == ["dl4j_matmul_stats_tf32x3"]
    else:
        with pytest.raises(RuntimeError, match=r"tf32x3.*CUDA error 719"):
            cf.conv3x3_with_channel_stats(_aligned(2, 9, 9, 32),
                                          _aligned(3, 3, 32, 64))
        assert lib.calls == ["dl4j_conv3x3_stats_tf32x3"]
    assert set(cf.LAUNCHES_BY_DESIGN.values()) == {0}
    assert set(cf.LAUNCHES.values()) == {0}


def test_a_failing_build_raises_without_falling_back(monkeypatch):
    def library(name):
        raise RuntimeError("nvcc failed for conv_fused")

    _route_as_on_a_card(monkeypatch, library)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cf.matmul_with_channel_stats(_aligned(64, 32), _aligned(32, 64))
