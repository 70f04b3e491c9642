"""The port's full-batch solvers against the JAX package's, on the CPU
in float64.

`backtrack_line_search` (Armijo, and alpha 0 when no step descends),
`minimize_cg` / `minimize_lbfgs` / `minimize_gd` on the same functions
and starting points: histories and final points within 1e-8 relative
over 10+ iterations, one host read a line-search probe (`syncs`).
`fit` under each algorithm on both runtimes against JAX's fit from the
same weights: loss histories, parameters and the batch-norm running
statistics the solver refreshes (`min(4 * iterations, 60)` passes)
within 1e-8. The solver writes back into the net's tensors in place.
The refusals of non-SGD `fit` this replaces are tests of the behaviour
now (`test_torch_training.py`, `test_torch_graph.py`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.inputs import InputType as JaxIT
from deeplearning4j_tpu.optim import solvers as js
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy,
)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.optim import solvers as ps
from deeplearning4j_tpu_torch.utils.pytrees import ravel_leaves

TOL = dict(rtol=1e-8, atol=1e-10)
ALGOS = ["conjugate_gradient", "lbfgs", "line_gradient_descent"]


def _rosen(lib):
    def f(x):
        return (100.0 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2
                + 100.0 * (x[2] - x[1] ** 2) ** 2 + (1 - x[1]) ** 2)
    return f


def _quad(lib, a, b):
    def f(x):
        return 0.5 * (x * lib(a) * x).sum() - (lib(b) * x).sum()
    return f


def test_line_search_armijo_and_no_descent():
    f = _quad(torch.tensor, np.array([1.0, 10.0]), np.array([1.0, 1.0]))
    x = torch.tensor([3.0, 3.0], dtype=torch.float64, requires_grad=True)
    f0 = f(x)
    g, = torch.autograd.grad(f0, x)
    x, f0 = x.detach(), f0.detach()
    syncs = ps._Syncs()
    alpha, fnew = ps.backtrack_line_search(f, x, f0, g, -g, syncs=syncs)
    assert alpha > 0 and float(fnew) <= float(f0 - 1e-4 * alpha * g @ g)
    ja, jf = js.backtrack_line_search(
        _quad(jnp.asarray, np.array([1.0, 10.0]), np.array([1.0, 1.0])),
        jnp.asarray(x.numpy()), jnp.asarray(f0.numpy()),
        jnp.asarray(g.numpy()), -jnp.asarray(g.numpy()))
    assert alpha == float(ja) and syncs.n == 1 + round(np.log2(1 / alpha))
    np.testing.assert_allclose(float(fnew), float(jf), **TOL)
    # an ascent direction: no alpha satisfies Armijo, f0 kept, 21 probes
    syncs = ps._Syncs()
    alpha, fnew = ps.backtrack_line_search(f, x, f0, g, g, syncs=syncs)
    assert alpha == 0.0 and fnew is f0 and syncs.n == 21


# Rosenbrock's curved valley amplifies the packages' last-bit rounding
# differences by about 10x every two iterations under L-BFGS (1e-15 at
# iteration 8, 1e-11 at 20, 1e-6 at 30): 20 iterations stay far inside
# 1e-8.
CASES = {
    "rosenbrock": (_rosen, np.array([-1.2, 1.0, 1.0]), 20),
    "quadratic": (lambda lib: _quad(lib, np.array([1.0, 5.0, 25.0, 2.0]),
                                    np.array([1.0, 2.0, 3.0, -1.0])),
                  np.zeros(4), 12),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("algo", ["cg", "lbfgs", "gd"])
def test_minimizers_match_jax(case, algo):
    make, x0, iters = CASES[case]
    jfn = {"cg": js.minimize_cg, "lbfgs": js.minimize_lbfgs,
           "gd": js.minimize_gd}[algo]
    pfn = {"cg": ps.minimize_cg, "lbfgs": ps.minimize_lbfgs,
           "gd": ps.minimize_gd}[algo]
    kw = {"history": 3} if algo == "lbfgs" else {}
    jr = jfn(make(jnp.asarray), jnp.asarray(x0), iterations=iters, **kw)
    pr = pfn(make(torch.tensor), torch.tensor(x0), iterations=iters, **kw)
    np.testing.assert_allclose(pr.history.numpy(), np.asarray(jr.history),
                               **TOL)
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), **TOL)
    np.testing.assert_allclose(float(pr.loss), float(jr.loss), **TOL)
    assert np.all(np.diff(pr.history.numpy()) <= 1e-12)
    assert iters <= pr.syncs <= 21 * iters


def _data(seed=0, n=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4))
    y = np.eye(3)[(x[:, 0] > 0).astype(int) + (x[:, 1] > 0.5)]
    return x, y


def _layers(m, bn):
    out = [m.DenseLayer(n_out=6, activation="tanh")]
    if bn:
        out.append(m.BatchNormalization())
    out.append(m.OutputLayer(n_out=3, activation="softmax"))
    return out


@pytest.mark.parametrize("bn", [False, True], ids=["dense", "batchnorm"])
@pytest.mark.parametrize("algo", ALGOS)
def test_sequential_fit_matches_jax(algo, bn):
    conf = (JaxNNC.builder().seed(1).dtype("float64")
            .optimization_algo(algo, iterations=10)
            .list(*_layers(jl, bn)).set_input_type(JaxIT.feed_forward(4))
            .build())
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    state_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                  jnet.state_tree))
    ptrs = [t.data_ptr() for t in ravel_leaves(pnet.params_tree)]
    x, y = _data()
    jnet.fit(x, y, batch_size=len(x))
    pnet.fit(x, y, batch_size=len(x))
    np.testing.assert_allclose(pnet.score_, float(jnet.score_), **TOL)
    np.testing.assert_allclose(pnet.params().numpy(), jnet.params(), **TOL)
    for name, st in pnet.state_tree.items():
        for k, v in st.items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(jnet.state_tree[name][k]), **TOL)
    assert ptrs == [t.data_ptr() for t in ravel_leaves(pnet.params_tree)]
    hist = pnet._solver.optimize(*pnet._batch_fields(
        pnet._put_batch(pnet_ds(x, y))))
    jh = jnet._solver.optimize(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(hist.numpy(), np.asarray(jh), **TOL)
    assert pnet._solver.solver_syncs >= 20


def pnet_ds(x, y):
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    return DataSet(x, y)


@pytest.mark.parametrize("algo", ALGOS)
def test_graph_fit_matches_jax(algo):
    """Once refused naming A1: a ComputationGraph fits under each
    solver as JAX's does."""
    g = (JaxNNC.builder().seed(7).dtype("float64")
         .optimization_algo(algo, iterations=10).graph_builder()
         .add_inputs("in").set_input_types(JaxIT.feed_forward(4)))
    g.add_layer("h", jl.DenseLayer(n_out=6, activation="tanh"), "in")
    g.add_layer("bn", jl.BatchNormalization(), "h")
    g.add_layer("out", jl.OutputLayer(n_out=3, activation="softmax"), "bn")
    g.set_outputs("out")
    jnet = JaxGraph(g.build()).init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    state_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                  jnet.state_tree))
    x, y = _data(2)
    jnet.fit(x, y, epochs=2, batch_size=len(x))
    pnet.fit(x, y, epochs=2, batch_size=len(x))
    np.testing.assert_allclose(pnet.score_, float(jnet.score_), **TOL)
    np.testing.assert_allclose(pnet.params().numpy(), jnet.params(), **TOL)
    np.testing.assert_allclose(pnet.state_tree["bn"]["mean"].numpy(),
                               np.asarray(jnet.state_tree["bn"]["mean"]),
                               **TOL)


def test_solver_cache_and_unknown_algo():
    with pytest.raises(ValueError, match="newton"):
        ps.Solver(object(), "newton")
    conf = (JaxNNC.builder().seed(1).optimization_algo("cg", iterations=3)
            .list(*_layers(jl, False)).set_input_type(JaxIT.feed_forward(4))
            .build())
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    x, y = _data(3)
    pnet.fit(x, y, batch_size=12)
    first = pnet._solver
    assert first.algo == "conjugate_gradient" and first.iterations == 3
    pnet.fit(x, y, batch_size=12)
    assert pnet._solver is first and pnet.fit_stats["eager_steps"] == 4
    import dataclasses
    pnet.conf = dataclasses.replace(pnet.conf, optimization_algo="lbfgs")
    pnet.fit(x, y, batch_size=24)
    assert pnet._solver is not first and pnet._solver.algo == "lbfgs"
    assert pnet.fit_stats["graph_windows"] == 0
