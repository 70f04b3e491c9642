"""The plain versions of the port's fused Adam kernel B1a and fused
Nesterovs kernel B1b, and the port's `Adam.update_with_params` and
`Nesterovs.update_with_params`, against the JAX package on the CPU: the
Pallas `adam_update` and `nesterov_update` in interpret mode, and JAX's
updaters on their XLA path and on their fused path
(`DL4J_TPU_FUSED_UPDATE=fused`). Same seeded numpy
inputs on both sides. Tolerances: float32 parameters within 1e-6
relative (plus 1e-7 absolute: both sides round the same operations in
float32, and XLA may fuse a multiply-add); bfloat16 parameters within
one bf16 step (2**-7 relative, plus 1e-6 absolute for a moment that
cancels to about zero, where one side rounds to 0 and the other to a
few 1e-9)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops.fused_update import adam_update as jax_adam_update
from deeplearning4j_tpu.optim.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.ops import fused_update as fu
from deeplearning4j_tpu_torch.optim.updaters import Adam

SIZES = [1, 127, 129, 1000]


def _leaf(rng, n):
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            (0.1 * rng.standard_normal(n)).astype(np.float32),
            rng.random(n).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_b1a_matches_pallas(n, dtype):
    rng = np.random.default_rng(n)
    p, g, m, v = _leaf(rng, n)
    b1, b2, eps, lrbc = 0.8, 0.99, 1e-6, 0.0123
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_adam_update(*(jnp.asarray(a, jd) for a in (p, g, m, v)),
                           jnp.float32(lrbc), beta1=b1, beta2=b2, eps=eps,
                           interpret=True)
    got = fu.adam_update_plain(*(torch.from_numpy(a).to(td)
                                 for a in (p, g, m, v)),
                               torch.tensor(lrbc), beta1=b1, beta2=b2,
                               eps=eps)
    tol = (dict(rtol=2.0 ** -7, atol=1e-6) if dtype == "bfloat16"
           else dict(rtol=1e-6, atol=1e-7))
    for a, b in zip(got, want):
        assert a.dtype == td
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b).astype(np.float32), **tol)


def test_multi_leaf_wrapper_updates_in_place_on_cpu():
    rng = np.random.default_rng(0)
    leaves = [tuple(torch.from_numpy(a) for a in _leaf(rng, n))
              for n in SIZES]
    ref = [fu.adam_update_plain(*leaf, torch.tensor(0.01)) for leaf in leaves]
    ptrs = [leaf[0].data_ptr() for leaf in leaves]
    fu.adam_update(*zip(*leaves), torch.tensor(0.01))
    for (p, _, m, v), r, ptr in zip(leaves, ref, ptrs):
        assert p.data_ptr() == ptr
        for got, want in zip((p, m, v), r):
            assert torch.equal(got, want)


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"l0": {"W": (5, 3), "b": (3,)}, "l1": {"W": (3, 129)}}
    mk = lambda: {n: {k: rng.standard_normal(s).astype(np.float32)  # noqa
                      for k, s in sub.items()} for n, sub in shapes.items()}
    return mk(), mk()


def _torch_tree(tree):
    return {n: {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
            for n, sub in tree.items()}


@pytest.mark.parametrize("jax_path", ["xla", "fused"])
def test_adam_update_with_params_matches_jax(jax_path, monkeypatch):
    """Three steps of the port's Adam (its B1a seam, the plain version on
    CPU tensors) against JAX's, a schedule-free lr and ε 1e-3 (a large ε:
    the first step's m/√v would otherwise flip sign on near-zero
    gradients with the last bit of a sum)."""
    monkeypatch.setenv("DL4J_TPU_FUSED_UPDATE", jax_path)
    params, _ = _trees(1)
    ju = JaxAdam(learning_rate=0.01, beta1=0.85, beta2=0.995, epsilon=1e-3)
    pu = Adam(learning_rate=0.01, beta1=0.85, beta2=0.995, epsilon=1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = ju.init(jp)
    tp = _torch_tree(params)
    ts = pu.init(tp)
    for step in range(3):
        grads, _ = _trees(10 + step)
        jp, js = ju.update_with_params(
            jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
            jnp.asarray(step, jnp.int32))
        tp2, ts2 = pu.update_with_params(_torch_tree(grads), ts, tp,
                                         torch.tensor(step))
        assert tp2 is tp and ts2 is ts       # in place
    for n in params:
        for k in params[n]:
            np.testing.assert_allclose(tp[n][k].numpy(),
                                       np.asarray(jp[n][k]),
                                       rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                np.testing.assert_allclose(ts[mom][n][k].numpy(),
                                           np.asarray(js[mom][n][k]),
                                           rtol=1e-6, atol=1e-7)


def test_epsilon_sits_outside_the_bias_corrected_sqrt():
    """ND4J's Adam: update = lr·√(1-β2^t)/(1-β1^t) · m / (√v + ε). It
    equals torch.optim.Adam (ε added to √v̂ = √v/√(1-β2^t)) only with ε
    scaled by √(1-β2^t), which pins where ε sits."""
    rng = np.random.default_rng(5)
    p0, g = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    lr, b1, b2, eps, steps = 0.05, 0.9, 0.999, 1e-2, 3
    u = Adam(learning_rate=lr, beta1=b1, beta2=b2, epsilon=eps)
    tp = {"l": {"W": torch.from_numpy(p0.copy())}}
    st = u.init(tp)
    for step in range(steps):
        u.update_with_params({"l": {"W": torch.from_numpy(g)}}, st, tp,
                             torch.tensor(step))
    # torch.optim.Adam, one step at a time with ε rescaled to ND4J's
    prm = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([prm], lr=lr, betas=(b1, b2), eps=eps)
    for t in range(1, steps + 1):
        opt.param_groups[0]["eps"] = eps / np.sqrt(1 - b2 ** t)
        prm.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp["l"]["W"].numpy(), prm.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    # and with torch's own ε placement the trajectories differ
    prm2 = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt2 = torch.optim.Adam([prm2], lr=lr, betas=(b1, b2), eps=eps)
    for _ in range(steps):
        prm2.grad = torch.from_numpy(g)
        opt2.step()
    assert np.abs(tp["l"]["W"].numpy() - prm2.detach().numpy()).max() > 1e-4


OTHERS = [("Sgd", dict(learning_rate=0.1)),
          ("Nesterovs", dict(learning_rate=0.1, momentum=0.8)),
          ("AdaMax", dict(learning_rate=0.01, epsilon=1e-3)),
          ("Nadam", dict(learning_rate=0.01, epsilon=1e-3)),
          ("AMSGrad", dict(learning_rate=0.01, epsilon=1e-3)),
          ("AdaGrad", dict(learning_rate=0.1)),
          ("AdaDelta", dict()),
          ("RmsProp", dict(learning_rate=0.01, epsilon=1e-3)),
          ("NoOp", dict())]


@pytest.mark.parametrize("name,kw", OTHERS, ids=[n for n, _ in OTHERS])
def test_other_updaters_match_jax(name, kw):
    """Two in-place steps of every other updater of the file (plain
    tensor math) against JAX's, and `resolve_updater` by name."""
    from deeplearning4j_tpu.optim import updaters as ju_mod
    from deeplearning4j_tpu_torch.optim import updaters as pu_mod

    params, _ = _trees(2)
    ju = getattr(ju_mod, name)(**kw)
    pu = getattr(pu_mod, name)(**kw)
    assert type(pu_mod.resolve_updater(name.lower())) is type(pu)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = ju.init(jp)
    tp = _torch_tree(params)
    ts = pu.init(tp)
    for step in range(2):
        grads, _ = _trees(20 + step)
        jp, js = ju.update_with_params(
            jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
            jnp.asarray(step, jnp.int32))
        pu.update_with_params(_torch_tree(grads), ts, tp, torch.tensor(step))
    for n in params:
        for k in params[n]:
            np.testing.assert_allclose(tp[n][k].numpy(),
                                       np.asarray(jp[n][k]), rtol=1e-6,
                                       atol=1e-7)


# ------------------------------------------------- Nesterovs (B1b)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (127,), (129,), (1000,), (),
                                   (5, 3)],
                         ids=["1", "127", "129", "1000", "scalar", "5x3"])
def test_plain_b1b_matches_pallas(shape, dtype):
    """The plain version of kernel B1b against the Pallas
    `nesterov_update` in interpret mode: odd sizes, a scalar leaf, a
    matrix; the stored dtype is kept."""
    from deeplearning4j_tpu.ops.fused_update import (
        nesterov_update as jax_nesterov_update,
    )

    rng = np.random.default_rng(int(np.prod(shape)) + len(shape))
    p, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    v = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_nesterov_update(*(jnp.asarray(a, jd) for a in (p, g, v)),
                               jnp.float32(0.05), momentum=0.8,
                               interpret=True)
    got = fu.nesterov_update_plain(*(torch.from_numpy(np.asarray(a)).to(td)
                                     for a in (p, g, v)),
                                   torch.tensor(0.05), momentum=0.8)
    tol = (dict(rtol=2.0 ** -7, atol=1e-6) if dtype == "bfloat16"
           else dict(rtol=1e-6, atol=1e-7))
    for a, b in zip(got, want):
        assert a.dtype == td and tuple(a.shape) == tuple(shape)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b).astype(np.float32), **tol)


def test_nesterov_multi_leaf_wrapper_updates_in_place_on_cpu():
    rng = np.random.default_rng(2)
    leaves = [tuple(torch.from_numpy(a) for a in _leaf(rng, n)[:3])
              for n in SIZES]
    lr = torch.tensor(0.05)
    ref = [fu.nesterov_update_plain(*leaf, lr, momentum=0.7)
           for leaf in leaves]
    ptrs = [leaf[0].data_ptr() for leaf in leaves]
    before = dict(fu.LAUNCHES)
    fu.nesterov_update(*zip(*leaves), lr, momentum=0.7)
    assert fu.LAUNCHES == before               # nothing launched on a CPU
    for (p, _, v), r, ptr in zip(leaves, ref, ptrs):
        assert p.data_ptr() == ptr
        assert torch.equal(p, r[0]) and torch.equal(v, r[1])
    with pytest.raises(ValueError, match="differ in length"):
        fu.nesterov_update([leaves[0][0]], [], [leaves[0][2]], lr)


@pytest.mark.parametrize("jax_path", ["xla", "fused"])
def test_nesterovs_update_with_params_matches_jax(jax_path, monkeypatch):
    """Three steps of the port's Nesterovs (its B1b seam, the plain
    version on CPU tensors) with an exponential schedule against JAX's,
    on its XLA path and on its fused path."""
    from deeplearning4j_tpu.optim.schedules import (
        ExponentialSchedule as JaxExp,
    )
    from deeplearning4j_tpu.optim.updaters import Nesterovs as JaxNesterovs
    from deeplearning4j_tpu_torch.optim.schedules import ExponentialSchedule
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    monkeypatch.setenv("DL4J_TPU_FUSED_UPDATE", jax_path)
    params, _ = _trees(3)
    ju = JaxNesterovs(learning_rate=JaxExp(initial=0.1, decay_rate=0.5),
                      momentum=0.8)
    pu = Nesterovs(learning_rate=ExponentialSchedule(initial=0.1,
                                                     decay_rate=0.5),
                   momentum=0.8)
    assert "apply" not in vars(Nesterovs)    # the arithmetic lives in B1b
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = ju.init(jp)
    tp = _torch_tree(params)
    ts = pu.init(tp)
    for step in range(3):
        grads, _ = _trees(30 + step)
        jp, js = ju.update_with_params(
            jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
            jnp.asarray(step, jnp.int32))
        tp2, ts2 = pu.update_with_params(_torch_tree(grads), ts, tp,
                                         torch.tensor(step))
        assert tp2 is tp and ts2 is ts       # in place
    for n in params:
        for k in params[n]:
            np.testing.assert_allclose(tp[n][k].numpy(),
                                       np.asarray(jp[n][k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts["v"][n][k].numpy(),
                                       np.asarray(js["v"][n][k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind,kernel", [("adam", "B1a"),
                                         ("nesterov", "B1b")])
def test_fused_update_policy_is_fused_on_the_card_plain_on_cpu(kind, kernel):
    from deeplearning4j_tpu_torch.ops.kernel_defaults import (
        fused_update_policy,
    )

    on_card = fused_update_policy(kind, "cuda")
    assert on_card.kind == "fused" and kernel in on_card.reason
    assert fused_update_policy(kind, "cpu").kind == "plain"
    with pytest.raises(ValueError, match="unknown fused update"):
        fused_update_policy("rmsprop")
