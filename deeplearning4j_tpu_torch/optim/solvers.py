"""Full-batch solvers: backtracking line search, nonlinear conjugate
gradient, L-BFGS and line gradient descent (port of
`deeplearning4j_tpu/optim/solvers.py`; DL4J's `optimize/Solver.java`
and `optimize/solvers/{ConjugateGradient,LBFGS,LineGradientDescent,
BackTrackLineSearch}.java`).

The JAX package traces a whole `optimize()` into one program; eager
torch cannot, because the Armijo loop's trip count depends on the data.
So the arithmetic stays on the device and the host reads ONE scalar per
line-search probe (did the probe satisfy the Armijo condition?) and
nothing else: the conjugate-gradient restart, L-BFGS's curvature check
and its ring of (s, y) pairs are `torch.where` selections on the
device, and the loss history stays there. `SolverResult.syncs` (and
`Solver.solver_syncs`, summed over its calls) counts those reads.

These are batch methods: the loss closure must be deterministic (no
dropout), as DL4J uses them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from deeplearning4j_tpu_torch.utils.pytrees import (
    copy_flat_, flatten_params,
)


class _Syncs:
    """Host reads of the line search (one per probe)."""

    def __init__(self):
        self.n = 0


class SolverResult(NamedTuple):
    x: torch.Tensor           # final parameter vector
    loss: torch.Tensor        # final loss (0-d, on the device)
    history: torch.Tensor     # per-iteration loss [iterations], on the device
    syncs: int                # host reads: one per line-search probe


def _value_and_grad(f: Callable):
    def vg(x):
        with torch.enable_grad():
            v = x.detach().requires_grad_(True)
            val = f(v)
            g, = torch.autograd.grad(val, v)
        return val.detach(), g
    return vg


def _probe(f: Callable):
    def fn(x):
        with torch.no_grad():
            return f(x)
    return fn


def backtrack_line_search(f: Callable, x: torch.Tensor, f0, g: torch.Tensor,
                          d: torch.Tensor, *, initial_step: float = 1.0,
                          c: float = 1e-4, rho: float = 0.5,
                          max_steps: int = 20, syncs: _Syncs = None):
    """Armijo backtracking: the largest alpha in {s, s*rho, s*rho^2, ...}
    (at most `max_steps` reductions) with f(x + alpha d) <= f0 +
    c * alpha * g.d. Returns (alpha, f_new): alpha a Python float, 0.0
    with f0 when no trial satisfies the condition (DL4J's
    BackTrackLineSearch bails the same way). Each probe reads one bool
    to the host."""
    f = _probe(f)
    gd = torch.dot(g, d)
    alpha = float(initial_step)
    fval = f(x + alpha * d)
    it = 0
    while True:
        ok = bool(fval <= f0 + c * alpha * gd)
        if syncs is not None:
            syncs.n += 1
        if ok:
            return alpha, fval
        if it >= max_steps:
            return 0.0, f0
        alpha = alpha * rho
        fval = f(x + alpha * d)
        it += 1


def _result(x, fval, hist, syncs):
    return SolverResult(x, fval, torch.stack(hist) if hist
                        else fval.reshape(0), syncs.n)


def minimize_cg(f: Callable, x0: torch.Tensor, *, iterations: int = 100,
                max_line_search: int = 20) -> SolverResult:
    """Polak-Ribiere+ nonlinear conjugate gradient with Armijo line
    search along the unit direction and restart (beta clamped at 0, the
    direction reset to -g when it is not a descent direction)."""
    vg, syncs = _value_and_grad(f), _Syncs()
    x = x0.detach()
    fval, g = vg(x)
    d = -g
    hist = []
    for _ in range(iterations):
        d_unit = d / torch.clamp(torch.linalg.vector_norm(d), min=1e-12)
        alpha, _ = backtrack_line_search(f, x, fval, g, d_unit,
                                         max_steps=max_line_search,
                                         syncs=syncs)
        x = x + alpha * d_unit
        fnew, g_new = vg(x)
        beta = torch.clamp(torch.dot(g_new, g_new - g)
                           / torch.clamp(torch.dot(g, g), min=1e-30),
                           min=0.0)
        d = -g_new + beta * d
        d = torch.where(torch.dot(d, g_new) < 0, d, -g_new)
        fval, g = fnew, g_new
        hist.append(fnew)
    return _result(x, fval, hist, syncs)


def _row(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx] for a 0-d device index, without reading it to the host."""
    return torch.index_select(a, 0, idx.reshape(1))[0]


def minimize_lbfgs(f: Callable, x0: torch.Tensor, *, iterations: int = 100,
                   history: int = 10,
                   max_line_search: int = 20) -> SolverResult:
    """L-BFGS: the two-loop recursion over a ring of `history` (s, y)
    pairs, a pair stored only when s.y > 1e-10 (the curvature check),
    steepest descent when the direction is not a descent one, Armijo
    backtracking. The ring, its count and every selection live on the
    device."""
    vg, syncs = _value_and_grad(f), _Syncs()
    m = history
    x = x0.detach()
    dev, dt = x.device, x.dtype
    fval, g = vg(x)
    S = torch.zeros((m, x.shape[0]), dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((m,), dtype=dt, device=dev)
    k = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def two_loop(g):
        q = g
        a = torch.zeros((m,), dtype=dt, device=dev)
        for i in range(m):
            idx = torch.remainder(k - 1 - i, m)
            r_i = _row(rho, idx)
            ai = torch.where(r_i > 0, r_i * torch.dot(_row(S, idx), q), zero)
            q = q - ai * _row(Y, idx)
            a = a.index_copy(0, idx.reshape(1), ai.reshape(1))
        newest = torch.remainder(k - 1, m)
        s_n, y_n = _row(S, newest), _row(Y, newest)
        sy, yy = torch.dot(s_n, y_n), torch.dot(y_n, y_n)
        gamma = torch.where(yy > 0, sy / torch.clamp(yy, min=1e-30),
                            torch.ones_like(yy))
        r = gamma * q
        for i in range(m):
            idx = torch.remainder(k - m + i, m)
            r_i = _row(rho, idx)
            bi = r_i * torch.dot(_row(Y, idx), r)
            corr = (_row(a, idx) - bi) * _row(S, idx)
            r = r + torch.where(r_i > 0, corr, zero)
        return r

    hist = []
    for _ in range(iterations):
        d = -two_loop(g)
        d = torch.where(torch.dot(d, g) < 0, d, -g)
        alpha, _ = backtrack_line_search(f, x, fval, g, d,
                                         max_steps=max_line_search,
                                         syncs=syncs)
        x_new = x + alpha * d
        fnew, g_new = vg(x_new)
        s, y = x_new - x, g_new - g
        sy = torch.dot(s, y)
        store = sy > 1e-10
        at = torch.remainder(k, m).reshape(1)
        S = torch.where(store, S.index_copy(0, at, s[None]), S)
        Y = torch.where(store, Y.index_copy(0, at, y[None]), Y)
        rho = torch.where(store, rho.index_copy(
            0, at, (1.0 / torch.clamp(sy, min=1e-30)).reshape(1)), rho)
        k = torch.where(store, k + 1, k)
        x, fval, g = x_new, fnew, g_new
        hist.append(fnew)
    return _result(x, fval, hist, syncs)


def minimize_gd(f: Callable, x0: torch.Tensor, *, iterations: int = 100,
                max_line_search: int = 20) -> SolverResult:
    """Line (steepest) gradient descent: the unit gradient direction and
    the Armijo line search."""
    vg, syncs = _value_and_grad(f), _Syncs()
    x = x0.detach()
    fval, g = vg(x)
    hist = []
    for _ in range(iterations):
        d = -g / torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
        alpha, _ = backtrack_line_search(f, x, fval, g, d,
                                         max_steps=max_line_search,
                                         syncs=syncs)
        x = x + alpha * d
        fval, g = vg(x)
        hist.append(fval)
    return _result(x, fval, hist, syncs)


_ALGOS = {
    "conjugate_gradient": minimize_cg,
    "cg": minimize_cg,
    "lbfgs": minimize_lbfgs,
    "line_gradient_descent": minimize_gd,
}


class Solver:
    """The model-level solver (DL4J's `Solver`): the net's parameter tree is
    flattened into one vector (`MultiLayerNetwork.params()`'s order),
    minimized on one batch by the configured algorithm, and copied back
    into the net's tensors in place. The model supplies
    `_solver_loss(params, states, fields)` over its batch fields and
    `_solver_finish(fields, passes, loss)`, which refreshes its running
    statistics and keeps the score."""

    def __init__(self, model, algo: str = "lbfgs", *, iterations: int = 100,
                 history: int = 10):
        if algo not in _ALGOS:
            raise ValueError(
                f"Unknown solver algorithm {algo!r}; known: {sorted(_ALGOS)}")
        self.model = model
        self.algo = algo
        self.iterations = iterations
        self.history = history
        self.solver_syncs = 0
        self.last_history = None

    def optimize(self, *fields) -> torch.Tensor:
        """Run the solver on ONE batch (the model's batch fields: for a
        MultiLayerNetwork features, labels, feature mask, label mask);
        returns the loss history, on the device.

        Afterwards the stateful layers' running statistics are refreshed
        by `min(4 * iterations, 60)` train-mode forwards at the final
        parameters, as the JAX package does (DL4J's solvers blend them
        once per forward, about 4 a iteration), and `score_` holds the
        final loss (read on demand); `last_history` keeps the last run's
        loss history, `solver_syncs` the host reads of every run."""
        model = self.model
        x0, unravel = flatten_params(model.params_tree)
        states = model.state_tree

        def flat_loss(v):
            loss, _ = model._solver_loss(unravel(v), states, fields)
            return loss

        kw = {"iterations": self.iterations}
        if self.algo == "lbfgs":
            kw["history"] = self.history
        res = _ALGOS[self.algo](flat_loss, x0, **kw)
        self.solver_syncs += res.syncs
        copy_flat_(model.params_tree, res.x)
        model._solver_finish(fields, min(4 * self.iterations, 60), res.loss)
        self.last_history = res.history
        return res.history


def fit_with_solver(model, *fields) -> torch.Tensor:
    """The non-SGD fit step of both runtimes: a `Solver` cached on the
    model (made anew when the configured algorithm or iteration count
    changes) runs one full-batch optimize; returns the final loss, on
    the device."""
    conf = model.conf
    cached = model._solver
    if (cached is None or cached.algo != conf.optimization_algo
            or cached.iterations != conf.solver_iterations):
        model._solver = Solver(model, conf.optimization_algo,
                               iterations=conf.solver_iterations)
    hist = model._solver.optimize(*fields)
    return hist[-1]
