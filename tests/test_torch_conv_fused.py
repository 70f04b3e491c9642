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
