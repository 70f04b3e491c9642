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


# ------------------------------------------------------- launch plans
def _adam_trees(rng, shapes, dtype=torch.float32):
    """(params, m, v) trees of `shapes` ({layer: {name: shape}}) and a
    gradient-tree maker, from seeded numpy."""
    def tree(scale=1.0, pos=False):
        return {n: {k: torch.from_numpy(
            (rng.random(s) if pos else scale * rng.standard_normal(s))
            .astype(np.float32)).to(dtype) for k, s in sub.items()}
                for n, sub in shapes.items()}
    return tree(), tree(0.1), tree(pos=True), lambda: tree()


SHAPES = {"l0": {"W": (5, 3), "b": (3,)}, "l1": {}, "l2": {"W": (3, 129)}}


def _counting_builds(monkeypatch):
    built = []

    class Counting(fu.LeafPlans):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(fu, "LeafPlans", Counting)
    return built


def test_a_leaf_set_builds_its_plan_once_and_reuses_it(monkeypatch):
    """Three Adam and three Nesterovs steps over one leaf set, each with
    a new gradient tree: one plan each, built at the first step, found
    again (identity of every p, m, v) at the next ones; the results equal
    the plain version's leaf by leaf."""
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    built = _counting_builds(monkeypatch)
    rng = np.random.default_rng(40)
    p, m, v, grads = _adam_trees(rng, SHAPES)
    u = Adam(learning_rate=0.01, beta1=0.8, beta2=0.99, epsilon=1e-3)
    state = {"m": m, "v": v}
    for step in range(3):
        g = grads()
        want = {(n, k): fu.adam_update_plain(
            p[n][k], g[n][k], m[n][k], v[n][k],
            fu.adam_lrbc_plain(torch.tensor(step), 0.01, 0.8, 0.99),
            beta1=0.8, beta2=0.99,
            eps=1e-3) for n in SHAPES for k in SHAPES[n]}
        u.update_with_params(g, state, p, torch.tensor(step))
        for (n, k), (wp, wm, wv) in want.items():
            assert torch.equal(p[n][k], wp) and torch.equal(m[n][k], wm)
            assert torch.equal(v[n][k], wv)
    assert len(built) == 1
    assert fu.leaf_plans("adam", p, m, v) is built[0]
    assert len(built[0].groups) == 1 and built[0].fast
    nu = Nesterovs(learning_rate=0.05, momentum=0.7)
    nstate = nu.init(p)
    for step in range(3):
        nu.update_with_params(grads(), nstate, p, torch.tensor(step))
    assert len(built) == 2 and built[1].kind == "nesterov"
    # the Nesterovs plan's constant rate is made once
    assert list(built[1]._constants) == [0.05]


def test_every_gradient_set_is_checked_and_bad_ones_raise(monkeypatch):
    """Gradients are checked on every call, a set seen before as much as
    a new one (nothing is kept per address set); each call updates with
    that call's gradients as the plain version does; a set of the wrong
    count, size, dtype or kind raises."""
    rng = np.random.default_rng(41)
    leaves = [tuple(torch.from_numpy(a) for a in _leaf(rng, n))
              for n in SIZES]
    ps, _, ms, vs = (list(c) for c in zip(*leaves))
    plan = fu.UpdatePlan("adam", ps, ms, vs)
    lr = torch.tensor(0.01)
    checked = []
    check = fu.UpdatePlan._check_grads
    monkeypatch.setattr(fu.UpdatePlan, "_check_grads",
                        lambda self, g: (checked.append(len(g)),
                                         check(self, g)))

    def grads():
        return [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                for n in SIZES]

    g1, g2 = grads(), grads()
    for g in (g1, g1, g2):
        want = [fu.adam_update_plain(p, gr, m, v, lr)
                for p, gr, m, v in zip(ps, g, ms, vs)]
        plan.launch(g, lr)
        for (wp, wm, wv), p, m, v in zip(want, ps, ms, vs):
            assert torch.equal(p, wp) and torch.equal(m, wm)
            assert torch.equal(v, wv)
    assert checked == [len(SIZES)] * 3
    assert not hasattr(plan, "grad_columns")
    with pytest.raises(TypeError, match="every gradient must be a tensor"):
        plan.launch([1.0] * len(SIZES), lr)
    wrong_size = grads()
    wrong_size[2] = torch.zeros(SIZES[2] + 1)
    with pytest.raises(ValueError, match="leaf 2: the gradient has"):
        plan.launch(wrong_size, lr)
    wrong_dtype = grads()
    wrong_dtype[1] = wrong_dtype[1].double()
    with pytest.raises(TypeError, match="leaf 1: the gradient is"):
        plan.launch(wrong_dtype, lr)
    with pytest.raises(ValueError, match="3 gradients for 4 leaves"):
        plan.launch(grads()[:3], lr)
    with pytest.raises(ValueError, match="leaf 0: m has"):
        fu.UpdatePlan("adam", ps, [torch.zeros(2)] + ms[1:], vs)


def test_a_group_past_max_leaves_is_cut_into_launches(monkeypatch):
    """A dtype group of more leaves than a launch takes (`MAX_LEAVES`,
    made 3 here) is cut into plans of at most that many, in order, by
    the updaters' plans and by the free functions alike; the leaves end
    as the plain version makes them."""
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    monkeypatch.setattr(fu, "MAX_LEAVES", 3)
    rng = np.random.default_rng(43)
    shapes = {f"l{i}": {"W": (i + 1, 2)} for i in range(7)}
    p, _, _, grads = _adam_trees(rng, shapes)
    u = Nesterovs(learning_rate=0.05, momentum=0.8)
    state = u.init(p)
    g = grads()
    want = {n: fu.nesterov_update_plain(p[n]["W"], g[n]["W"],
                                        state["v"][n]["W"],
                                        torch.tensor(0.05), momentum=0.8)
            for n in shapes}
    u.update_with_params(g, state, p, torch.tensor(0))
    plans = fu.leaf_plans("nesterov", p, None, state["v"])
    assert [idx for idx, _ in plans.groups] == [[0, 1, 2], [3, 4, 5], [6]]
    for n, (wp, wv) in want.items():
        assert torch.equal(p[n]["W"], wp)
        assert torch.equal(state["v"][n]["W"], wv)
    ps, gs, vs = ([t[n]["W"] for n in shapes] for t in (p, g, state["v"]))
    want = [fu.nesterov_update_plain(a, b, c, torch.tensor(0.05))
            for a, b, c in zip(ps, gs, vs)]
    built = []
    init = fu.UpdatePlan.__init__
    monkeypatch.setattr(fu.UpdatePlan, "__init__",
                        lambda self, kind, params, *a, **k: (
                            built.append(len(params)),
                            init(self, kind, params, *a, **k))[1])
    fu.nesterov_update(ps, gs, vs, torch.tensor(0.05))
    assert built == [3, 3, 1]
    for (wp, wv), a, c in zip(want, ps, vs):
        assert torch.equal(a, wp) and torch.equal(c, wv)


REBINDS = ["load", "set_params", "transfer", "updater_state"]


@pytest.mark.parametrize("how", REBINDS)
def test_a_rebound_state_tensor_builds_a_new_plan(how, monkeypatch):
    """After one step, the trees change as a load (every tensor new), a
    set_params (values copied in place: no tensor rebound), a transfer
    (one layer's dict replaced) or an updater-state restore (one moment
    rebound inside its dict while the old tensor lives on) change them;
    the next step builds a new plan exactly when a p, m or v tensor was
    rebound, and updates the live tensors as a fresh updater would."""
    built = _counting_builds(monkeypatch)
    rng = np.random.default_rng(42)
    p, m, v, grads = _adam_trees(rng, SHAPES)
    u = Adam(learning_rate=0.02)
    state = {"m": m, "v": v}
    u.update_with_params(grads(), state, p, torch.tensor(0))
    old = m["l0"]["W"]
    old_value = old.clone()
    if how == "load":
        p, m, v = ({n: {k: t.clone() for k, t in sub.items()}
                    for n, sub in tree.items()} for tree in (p, m, v))
        state = {"m": m, "v": v}
    elif how == "set_params":
        for sub in p.values():
            for t in sub.values():
                t.mul_(0.5)
    elif how == "transfer":
        p["l2"] = {"W": torch.from_numpy(
            rng.standard_normal((3, 129)).astype(np.float32))}
        m["l2"] = {"W": torch.zeros(3, 129)}
        v["l2"] = {"W": torch.zeros(3, 129)}
    else:
        m["l0"]["W"] = torch.from_numpy(
            rng.standard_normal((5, 3)).astype(np.float32))
    g = grads()
    fresh = {n: {k: t.clone() for k, t in sub.items()}
             for n, sub in p.items()}
    fresh_state = {key: {n: {k: t.clone() for k, t in sub.items()}
                         for n, sub in tree.items()}
                   for key, tree in state.items()}
    fu.UpdatePlan("adam", *(
        [t for sub in tree.values() for t in sub.values()]
        for tree in (fresh, fresh_state["m"], fresh_state["v"]))).launch(
        [t for sub in g.values() for t in sub.values()],
        fu.adam_lrbc_plain(torch.tensor(1), 0.02, u.beta1, u.beta2),
        beta1=u.beta1, beta2=u.beta2,
        eps=u.epsilon)
    u.update_with_params(g, state, p, torch.tensor(1))
    assert len(built) == (1 if how == "set_params" else 2)
    for n in SHAPES:
        for k in SHAPES[n]:
            assert torch.equal(p[n][k], fresh[n][k])
            assert torch.equal(state["m"][n][k], fresh_state["m"][n][k])
            assert torch.equal(state["v"][n][k], fresh_state["v"][n][k])
    if how in ("updater_state", "load"):
        assert torch.equal(old, old_value)   # the old moment is not touched


def test_a_net_reloaded_or_reset_in_place_keeps_training_right(tmp_path,
                                                               monkeypatch):
    """The net-level rebindings: `set_params` copies into the live
    tensors (the plan is kept); `load_model` makes new trees (a new plan);
    both go on training exactly as a net built from the same state."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serialize import (
        load_model, save_model,
    )
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

    built = _counting_builds(monkeypatch)
    conf = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2))
            .list(DenseLayer(n_out=8, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    rng = np.random.default_rng(43)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(x, y, epochs=2, batch_size=8)
    assert len(built) == 1
    net.set_params(net.params() * 0.5)
    path = tmp_path / "net.zip"
    save_model(net, path)
    twin = load_model(path, device="cpu")
    net.fit(x, y, epochs=1, batch_size=8)
    assert len(built) == 1                   # set_params rebinds nothing
    twin.fit(x, y, epochs=1, batch_size=8)
    assert len(built) == 2                   # a loaded net: its own plan
    assert torch.equal(net.params(), twin.params())


def test_mixed_float32_and_bfloat16_leaves_get_one_plan_each():
    """A leaf set mixing float32 and bfloat16 leaves: two groups, each
    one plan over its dtype's leaves in tree order, each updated as the
    plain version updates it."""
    rng = np.random.default_rng(44)
    p, m, v, grads = _adam_trees(rng, SHAPES)
    for tree in (p, m, v):
        tree["l0"]["b"] = tree["l0"]["b"].to(torch.bfloat16)
    g = grads()
    g["l0"]["b"] = g["l0"]["b"].to(torch.bfloat16)
    want = {(n, k): fu.adam_update_plain(p[n][k], g[n][k], m[n][k], v[n][k],
                                         torch.tensor(0.01))
            for n in SHAPES for k in SHAPES[n]}
    plans = fu.leaf_plans("adam", p, m, v)
    assert [(idx, plan.dtype) for idx, plan in plans.groups] == [
        ([0, 2], torch.float32), ([1], torch.bfloat16)]
    assert plans.groups[1][1].leaves()[0][0] is p["l0"]["b"]
    plans.run(plans.grads(g), torch.tensor(0.01))
    for (n, k), r in want.items():
        for got, w in zip((p[n][k], m[n][k], v[n][k]), r):
            assert got.dtype == w.dtype and torch.equal(got, w)


LAYOUTS = [[1], [fu.CHUNK], [fu.CHUNK + 1, 0, 127],
           [0, 5, 0, 4097, 1 << 20], [64] * 300 + [3 * fu.CHUNK + 7],
           [2 * fu.CHUNK] * 200]


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("sizes", LAYOUTS,
                         ids=["one", "chunk", "ragged", "empty", "irv1-ish",
                              "even"])
def test_block_layout_matches_a_plain_reckoning(sizes, sms):
    """Design 2's device table: each leaf's row (p, m, v, n, first chunk)
    and each block's run of chunks, against a reckoning written out
    here: chunks numbered leaf by leaf, min(chunks, 2 x SMs) blocks of
    contiguous chunks whose sizes differ by at most one, covering every
    chunk once, each starting at the leaf that owns its first chunk."""
    leaves = [[torch.zeros(n) for _ in range(3)] for n in sizes]
    ps, ms, vs = (list(c) for c in zip(*leaves))
    plan = fu.UpdatePlan("adam", ps, ms, vs, sms=sms)
    owner = []                       # chunk -> leaf
    for i, n in enumerate(sizes):
        owner += [i] * ((n + fu.CHUNK - 1) // fu.CHUNK)
    assert plan.n_chunks == len(owner)
    rows = plan._host[:5 * len(sizes)].view(-1, 5).tolist()
    for i, (p, m, v) in enumerate(leaves):
        first = owner.index(i) if i in owner else None
        assert rows[i][:4] == [p.data_ptr(), m.data_ptr(), v.data_ptr(),
                               sizes[i]]
        if first is not None:
            assert rows[i][4] == first
    blocks = plan._host[5 * len(sizes):].view(-1, 3).tolist()
    assert blocks == [list(b) for b in plan.blocks]
    assert len(blocks) == min(len(owner), fu.BLOCKS_PER_SM * sms)
    covered = [c for c0, c1, _ in blocks for c in range(c0, c1)]
    assert covered == list(range(len(owner)))
    lengths = [c1 - c0 for c0, c1, _ in blocks]
    assert max(lengths) - min(lengths) <= 1
    for c0, _, leaf in blocks:
        assert leaf == owner[c0]


def test_dispatch_counted_a_launch_and_the_plain_bias_correction():
    """Every launch takes design 2 unless asked (`DEFAULT_DESIGN`) and
    counts one `kernel_dispatch_total` of its op: "plain" on the CPU, a
    call after the plan was built as much as the first, and
    "fused/<design>" for the card; the plain bias-corrected rate is the
    updater's tensor operations, bit for bit, for a constant rate and a
    schedule's."""
    from deeplearning4j_tpu_torch.observe import get_registry
    from deeplearning4j_tpu_torch.ops.kernel_defaults import (
        fused_update_policy,
    )
    from deeplearning4j_tpu_torch.optim.schedules import ExponentialSchedule

    def count(op, impl):
        return get_registry().counter("kernel_dispatch_total", op=op,
                                      impl=impl).value

    assert fu.DEFAULT_DESIGN == "persistent" and fu.DEFAULT_DESIGN in \
        fu.DESIGNS
    rng = np.random.default_rng(44)
    leaves = [tuple(torch.from_numpy(a) for a in _leaf(rng, n))
              for n in SIZES]
    ps, gs, ms, vs = (list(c) for c in zip(*leaves))
    before = count("adam_update", "plain")
    plan = fu.UpdatePlan("adam", ps, ms, vs)
    assert count("adam_update", "plain") == before
    for k in range(3):
        plan.launch(gs, torch.tensor(1e-3))
        assert count("adam_update", "plain") == before + k + 1
    for d in fu.DESIGNS:
        before = count("nesterov_update", f"fused/{d}")
        fused_update_policy("nesterov", "cuda", d)
        assert count("nesterov_update", f"fused/{d}") == before + 1
    for lr in (3e-4, ExponentialSchedule(initial=0.1, decay_rate=0.5)):
        u = Adam(learning_rate=lr, beta1=0.85, beta2=0.995)
        for step in (0, 1, 7, 999, 123456):
            s = torch.tensor(step)
            t = s.to(torch.float32) + 1.0
            want = u.lr(t - 1.0) * torch.sqrt(1.0 - 0.995 ** t) / (
                1.0 - 0.85 ** t)
            rate = lr if isinstance(lr, float) else u.lr(t - 1.0)
            got = fu.adam_lrbc_plain(s, rate, 0.85, 0.995)
            assert torch.equal(got, want)
