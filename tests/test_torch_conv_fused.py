"""The fused conv + batch-norm statistics of the PyTorch port
(`deeplearning4j_tpu_torch/ops/conv_fused.py`) against the JAX package's
`ops/conv_fused.py`, on the CPU: the plain versions of kernels B7a
(`matmul_with_channel_stats`) and B7b (`conv3x3_with_channel_stats`)
against the Pallas kernels in interpret mode on shapes that tile and
against JAX's XLA fallback on shapes that do not, in float32, bfloat16
and float64; the two training Functions against `jax.grad` of
`conv1x1_bn_act` / `conv3x3_bn_act(train=True)` (strided 1×1, relu on
and off); the eval fold; the wrappers' CPU dispatch and checks; the
dispatch policy.

Tolerances: float32 y within 1e-5 of its largest magnitude (sums of K
products in another order), the statistics within 1e-5 relative of the
largest (sums of M such values); bfloat16 y within one bf16 step (2**-7
of the value: both sides sum in float32 and round once, and may land one
step apart) and the statistics as in float32, since both take them from
the float32 accumulator; float64 within 1e-12. The training outputs
within 1e-5 absolute (normalized values of order 1), the gradients
within 1e-4 of each gradient's largest magnitude (the batch-norm
backward subtracts sums of M terms)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops import conv_fused as jcf
from deeplearning4j_tpu_torch.ops import conv_fused as cf
from deeplearning4j_tpu_torch.ops.kernel_defaults import conv_fused_policy

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f64": (torch.float64, jnp.float64)}
# (M, K, N): the first two tile (Pallas in interpret mode), the last two
# do not (JAX takes its XLA fallback; the CUDA kernel takes every shape)
MM_SHAPES = [(64, 16, 32), (256, 64, 128), (37, 5, 7), (130, 19, 66)]
# (B, H, W, C_in, C_out): the first tiles, the others fall back
CONV_SHAPES = [(2, 8, 8, 16, 32), (2, 5, 6, 3, 4), (3, 7, 7, 5, 12)]


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().numpy()


def _jnp(a, dt):
    return jnp.asarray(a).astype(dt)


def _check_y(got, want, dtype):
    got, want = _np(got).astype(np.float64), np.asarray(
        want.astype(jnp.float32) if want.dtype == jnp.bfloat16 else want,
        np.float64)
    scale = max(np.abs(want).max(), 1.0)
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                   atol=1e-6 * scale)
    elif dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)


def _check_stats(got, want, dtype):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    tol = 1e-12 if dtype == "f64" else 1e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", MM_SHAPES,
                         ids=[f"{m}x{k}x{n}" for m, k, n in MM_SHAPES])
def test_plain_b7a_matches_jax(shape, dtype):
    m, k, n = shape
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k))
    w = rng.standard_normal((k, n)) / np.sqrt(k)
    jy, js, jq = jcf.matmul_with_channel_stats(_jnp(x, jdt), _jnp(w, jdt),
                                               interpret=True)
    tx, tw = torch.tensor(x).to(tdt), torch.tensor(w).to(tdt)
    y, s, q = cf.matmul_with_channel_stats_plain(tx, tw)
    assert y.dtype == tdt and s.dtype == cf._acc_dtype(tdt)
    _check_y(y, jy, dtype)
    _check_stats(s, js, dtype)
    _check_stats(q, jq, dtype)
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = dict(cf.LAUNCHES)
    y2, s2, q2 = cf.matmul_with_channel_stats(tx, tw)
    assert torch.equal(y2, y) and torch.equal(s2, s) and torch.equal(q2, q)
    assert cf.LAUNCHES == before


def test_bf16_statistics_come_from_the_accumulator():
    """In bfloat16 Σy and Σy² are taken before y is rounded: they equal
    the float32 product's sums, not the rounded y's."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((96, 24)), dtype=torch.bfloat16)
    w = torch.tensor(rng.standard_normal((24, 16)), dtype=torch.bfloat16)
    y, s, q = cf.matmul_with_channel_stats(x, w)
    exact = x.float() @ w.float()
    torch.testing.assert_close(s, exact.sum(0), rtol=0, atol=1e-4)
    torch.testing.assert_close(q, (exact * exact).sum(0), rtol=0,
                               atol=1e-3)
    rounded = y.float()
    assert (rounded.sum(0) - exact.sum(0)).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=["x".join(map(str, s)) for s in CONV_SHAPES])
def test_plain_b7b_matches_jax(shape, dtype):
    b, h, wd, cin, cout = shape
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, h, wd, cin))
    w = rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
    jy, js, jq = jcf.conv3x3_with_channel_stats(_jnp(x, jdt), _jnp(w, jdt),
                                                interpret=True)
    tx, tw = torch.tensor(x).to(tdt), torch.tensor(w).to(tdt)
    y, s, q = cf.conv3x3_with_channel_stats(tx, tw)
    assert tuple(y.shape) == (b, h, wd, cout) and y.dtype == tdt
    _check_y(y, jy, dtype)
    _check_stats(s, js, dtype)
    _check_stats(q, jq, dtype)


def test_wrappers_check_shapes():
    with pytest.raises(ValueError, match="x2d"):
        cf.matmul_with_channel_stats(torch.zeros(4, 3), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="3, 3"):
        cf.conv3x3_with_channel_stats(torch.zeros(1, 4, 4, 2),
                                      torch.zeros(3, 3, 3, 2))


def _bn_inputs(rng, shape, cout, k3):
    b, h, wd, cin = shape
    x = rng.standard_normal(shape)
    w = rng.standard_normal((3, 3, cin, cout) if k3 else (cin, cout)) \
        / np.sqrt(cin * (9 if k3 else 1))
    gamma = 1.0 + 0.3 * rng.standard_normal(cout)
    beta = 0.2 * rng.standard_normal(cout)
    return x, w, gamma, beta


TRAIN_CASES = [("1x1", (1, 1), True), ("1x1", (1, 1), False),
               ("1x1", (2, 2), True), ("1x1", (2, 2), False),
               ("3x3", (1, 1), True), ("3x3", (1, 1), False)]


@pytest.mark.parametrize("kind,stride,relu", TRAIN_CASES,
                         ids=[f"{k}-s{s[0]}-relu{r}" for k, s, r in
                              TRAIN_CASES])
def test_train_function_and_gradients_match_jax(kind, stride, relu):
    rng = np.random.default_rng(11 + stride[0] + relu)
    k3 = kind == "3x3"
    x, w, gamma, beta = _bn_inputs(rng, (2, 6, 5, 8), 16, k3)
    oh, ow = -(-6 // stride[0]), -(-5 // stride[1])
    r = rng.standard_normal((2, oh, ow, 16))

    def jfwd(x, w, g, bt):
        if k3:
            return jcf.conv3x3_bn_act(x, w, g, bt, eps=1e-5, relu=relu,
                                      train=True, interpret=True)
        return jcf.conv1x1_bn_act(x, w, g, bt, stride=stride, eps=1e-5,
                                  relu=relu, train=True, interpret=True)

    jargs = [jnp.asarray(a, jnp.float32) for a in (x, w, gamma, beta)]
    jout, jmean, jvar = jfwd(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(jfwd(*a)[0] * r),
                      argnums=(0, 1, 2, 3))(*jargs)

    targs = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
             for a in (x, w, gamma, beta)]
    if k3:
        out, mean, var = cf.conv3x3_bn_act(*targs, eps=1e-5, relu=relu,
                                           train=True)
    else:
        out, mean, var = cf.conv1x1_bn_act(*targs, stride=stride, eps=1e-5,
                                           relu=relu, train=True)
    assert not mean.requires_grad and not var.requires_grad
    (out * torch.tensor(r, dtype=torch.float32)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(_np(mean), np.asarray(jmean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(var), np.asarray(jvar), rtol=1e-5,
                               atol=1e-6)
    for name, t, jg in zip(("x", "w", "gamma", "beta"), targs, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(_np(t.grad), jg, rtol=0,
                                   atol=1e-4 * max(np.abs(jg).max(), 1e-3),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["1x1", "3x3"])
def test_bf16_train_forward_matches_jax(kind):
    """bfloat16 in and out, the statistics and the epilogue in float32:
    out within one bf16 step, mean and var within float32 rounding."""
    rng = np.random.default_rng(5)
    k3 = kind == "3x3"
    x, w, gamma, beta = _bn_inputs(rng, (2, 8, 8, 16), 32, k3)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, gamma,
                                                           beta)]
    targs = [torch.tensor(a).to(torch.bfloat16) for a in (x, w, gamma,
                                                          beta)]
    if k3:
        jout, jm, jv = jcf.conv3x3_bn_act(*jargs, train=True, interpret=True)
        out, m, v = cf.conv3x3_bn_act(*targs, train=True)
    else:
        jout, jm, jv = jcf.conv1x1_bn_act(*jargs, train=True, interpret=True)
        out, m, v = cf.conv1x1_bn_act(*targs, train=True)
    assert out.dtype == torch.bfloat16 and m.dtype == torch.float32
    jout = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(_np(out), jout, rtol=2.0 ** -7, atol=1e-2)
    np.testing.assert_allclose(_np(m), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(v), np.asarray(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,stride,relu", [("1x1", (1, 1), True),
                                              ("1x1", (2, 2), False),
                                              ("3x3", (1, 1), True),
                                              ("3x3", (1, 1), False)])
def test_eval_fold_matches_jax(kind, stride, relu):
    rng = np.random.default_rng(3)
    k3 = kind == "3x3"
    x, w, gamma, beta = _bn_inputs(rng, (2, 6, 6, 8), 12, k3)
    mean = 0.1 * rng.standard_normal(12)
    var = 0.5 + rng.random(12)
    jargs = [jnp.asarray(a, jnp.float32) for a in (x, w, gamma, beta)]
    targs = [torch.tensor(a, dtype=torch.float32) for a in (x, w, gamma,
                                                            beta)]
    stats = dict(mean=mean.astype(np.float32), var=var.astype(np.float32))
    if k3:
        want = jcf.conv3x3_bn_act(*jargs, relu=relu, **stats)
        got = cf.conv3x3_bn_act(*targs, relu=relu, **{
            k: torch.tensor(v) for k, v in stats.items()})
    else:
        want = jcf.conv1x1_bn_act(*jargs, stride=stride, relu=relu, **stats)
        got = cf.conv1x1_bn_act(*targs, stride=stride, relu=relu, **{
            k: torch.tensor(v) for k, v in stats.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_policy_verdicts():
    assert conv_fused_policy(torch.float32, train=True,
                             device="cpu").kind == "plain"
    assert conv_fused_policy(torch.float16, train=False,
                             device="cuda").kind == "fold"
    assert conv_fused_policy(torch.bfloat16, train=True,
                             device="cuda").kind == "fused"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv_fused_policy(torch.float16, train=True, device="cuda")


# ------------------------------------------- the choice of CUDA design
# (kernel, shape): bfloat16 shapes design 1 keeps (K or C, or N, not a
# multiple of 8) and ragged ones design 2 takes (M off its 128-row tile)
RAGGED = {("conv1x1_bn_stats", (1000, 37, 130)): "ffma",
          ("conv1x1_bn_stats", (129, 19, 65)): "ffma",
          ("conv3x3_bn_stats", (2, 5, 6, 3, 4)): "ffma",
          ("conv1x1_bn_stats", (147, 2048, 512)): "wgmma",
          ("conv3x3_bn_stats", (3, 7, 7, 512, 512)): "wgmma"}


def _path_r_shapes():
    import chip_smoke

    return sorted(chip_smoke.b7_path_shapes())


def test_b7_design_routes_by_dtype_shape_and_alignment():
    """Design 2 takes every path_r bfloat16 shape and the aligned ragged
    ones, design 3 every path_r float32 shape; the unaligned shapes and a
    pointer off 16 bytes stay on design 1."""
    aligned = (0, 256, 4096)
    for _, shape in _path_r_shapes():
        assert cf.b7_design(torch.bfloat16, shape, aligned) == "wgmma"
        assert cf.b7_design(torch.float32, shape, aligned) == "tf32x3"
        assert cf.b7_design(torch.bfloat16, shape, (8, 256, 4096)) == \
            "ffma"
        assert cf.b7_design(torch.float32, shape, (8, 256, 4096)) == \
            "ffma"
    for (_, shape), want in RAGGED.items():
        assert cf.b7_design(torch.bfloat16, shape, aligned) == want


def test_cuda_test_shapes_are_the_path_r_shapes():
    """`tests/test_torch_cuda_kernels.py` holds design 2 on the shapes
    `chip_smoke.b7_path_shapes()` reads off the configuration."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).with_name("test_torch_cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("_cuda_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert sorted(mod.B7_PATH_R_SHAPES) == _path_r_shapes()
    for kernel, shape in mod.B7_RAGGED_WGMMA:
        assert cf.b7_design(torch.bfloat16, shape, (0, 0, 0)) == "wgmma"


TILES = [((401408, 64, 64), (64, 4)), ((401408, 64, 256), (256, 3)),
         ((401408, 256, 64), (64, 4)), ((100352, 256, 128), (128, 4)),
         ((25088, 1024, 256), (256, 3)), ((6272, 2048, 512), (256, 3)),
         ((1000, 40, 136), (256, 3)), ((77, 8, 8), (64, 4)),
         ((100, 128, 96), (128, 4)), ((128, 7, 7, 512, 512), (256, 3)),
         ((128, 56, 56, 64, 64), (64, 4)), ((2, 5, 6, 8, 16), (64, 4))]


def _smem_bytes(bn, stages):
    """Design 2's shared memory (`tc::smem_bytes` in csrc/conv_fused.cu):
    alignment slack, the ring (a 128 x 64 slice of x and bn/64 boxes of
    64 x 64 of w a stage), the staged 128 x bn y tile, the partials and
    the barriers."""
    return 1024 + stages * (128 * 64 * 2 + bn // 64 * 64 * 64 * 2) \
        + 128 * bn * 2 + 2 * 8 * bn * 4 + 2 * stages * 8


@pytest.mark.parametrize("shape,want", TILES,
                         ids=["x".join(map(str, s)) for s, _ in TILES])
def test_wgmma_tile_columns_and_ring_depth(shape, want):
    """BN is N rounded up to 64, 128 or 256; the ring is as deep as fits
    in a block's 227 KB of shared memory beside the y tile, and never
    under two stages (a consumer gives a stage back one slice after it
    was filled)."""
    bn, stages = cf.wgmma_tile(shape)
    assert (bn, stages) == want
    assert 2 <= stages and _smem_bytes(bn, stages) <= 232448
    assert _smem_bytes(bn, stages + 1) > 232448 or stages == 4


def test_cpu_calls_take_the_plain_versions_and_count_no_design():
    before = dict(cf.LAUNCHES_BY_DESIGN)
    x = torch.randn(40, 16, dtype=torch.bfloat16)
    w = torch.randn(16, 8, dtype=torch.bfloat16)
    got = cf.matmul_with_channel_stats(x, w)
    want = cf.matmul_with_channel_stats_plain(x, w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cf.LAUNCHES_BY_DESIGN == before
    cf.reset_counts()
    assert set(cf.LAUNCHES_BY_DESIGN.values()) == {0}
    assert set(cf.LAUNCHES_BY_DESIGN) == {
        (k, d) for k in cf.LAUNCHES for d in cf.DESIGNS}
