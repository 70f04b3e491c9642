"""Numerical gradient checking (port of `deeplearning4j_tpu/gradientcheck.py`).

Reference parity: `gradientcheck/GradientCheckUtil.java:48`
(`checkGradients`): central-difference numeric gradients over the FLAT
parameter vector against the analytic ones, with a per-parameter
relative error. The analytic gradient is `torch.autograd` of the model's
loss (eval mode: no dropout, running batch-norm statistics), so the
check validates that each layer's forward is differentiable as written.
It runs in float64 on the CPU: the net must live there
(`device="cpu"`), and its parameters, state and inputs are cast to
float64 for the check, which leaves the net itself unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optim.updaters import tree_leaves, tree_map

DEFAULT_EPS = 1e-5
DEFAULT_MAX_REL_ERROR = 1e-3
DEFAULT_MIN_ABS_ERROR = 1e-8


def _f64(a) -> Optional[torch.Tensor]:
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.detach().to(device="cpu", dtype=torch.float64)


def _loss_of(model, features, labels, fmask, lmask):
    """`loss(params, states)` of a MultiLayerNetwork or ComputationGraph
    on one batch, eval mode."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph,
    )

    if isinstance(model, ComputationGraph):
        feats, labs, fms, lms = model._to_dicts(
            DataSet(features, labels, fmask, lmask))
        return lambda p, s: model._loss(p, s, feats, labs, fms, lms, None,
                                        train=False)[0]
    return lambda p, s: model._loss(p, features, labels, fmask, lmask, None,
                                    train=False, states=s)[0]


def check_gradients(model, features, labels, *, features_mask=None,
                    labels_mask=None, eps: float = DEFAULT_EPS,
                    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                    subset: Optional[int] = None, seed: int = 0,
                    print_results: bool = False) -> bool:
    """Central-difference check of a MultiLayerNetwork or
    ComputationGraph on the CPU. Returns True when every checked
    parameter's relative error is below `max_rel_error` (or its absolute
    error below `min_abs_error`).

    `subset`: if set, check only this many randomly-chosen parameters
    (the reference checks all; subsetting keeps CI fast for big nets)."""
    model._check_init()
    if model.device.type != "cpu":
        raise ValueError("check_gradients runs in float64 on the CPU: "
                         "build the net with device='cpu'")
    loss_fn = _loss_of(model, _f64(features), _f64(labels),
                       _f64(features_mask), _f64(labels_mask))
    params64 = tree_map(_f64, model.params_tree)
    states64 = tree_map(_f64, model.state_tree)
    leaves = tree_leaves(params64)
    sizes = [t.numel() for t in leaves]
    flat = torch.cat([t.reshape(-1) for t in leaves]) if leaves else \
        torch.zeros(0, dtype=torch.float64)

    def unravel(fv):
        it = iter(torch.split(fv, sizes))
        return tree_map(lambda t: next(it).reshape(t.shape), params64)

    def loss_flat(fv) -> torch.Tensor:
        return loss_fn(unravel(fv), states64)

    with torch.enable_grad():
        fv = flat.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(loss_flat(fv), fv, allow_unused=True)
    analytic = (np.zeros(flat.numel()) if grad is None
                else grad.numpy().astype(np.float64))
    flat_np = flat.numpy().astype(np.float64)
    n = flat_np.shape[0]

    idxs = np.arange(n)
    if subset is not None and subset < n:
        idxs = np.random.default_rng(seed).choice(n, subset, replace=False)

    failures = []
    with torch.no_grad():
        for i in idxs:
            orig = flat_np[i]
            fp = flat_np.copy()
            fp[i] = orig + eps
            fm = flat_np.copy()
            fm[i] = orig - eps
            numeric = (float(loss_flat(torch.from_numpy(fp)))
                       - float(loss_flat(torch.from_numpy(fm)))) / (2 * eps)
            a = analytic[i]
            abs_err = abs(a - numeric)
            denom = max(abs(a), abs(numeric))
            rel = abs_err / denom if denom > 0 else 0.0
            ok = rel < max_rel_error or abs_err < min_abs_error
            if not ok:
                failures.append((int(i), float(a), float(numeric),
                                 float(rel)))
            if print_results:
                print(f"param {i}: analytic={a:.8g} numeric={numeric:.8g} "
                      f"rel={rel:.3g} {'OK' if ok else 'FAIL'}")

    if failures:
        msg = "\n".join(
            f"  param {i}: analytic={a:.8g} numeric={nu:.8g} "
            f"relError={r:.3g}" for i, a, nu, r in failures[:20])
        print(f"Gradient check FAILED for {len(failures)}/{len(idxs)} "
              f"params:\n{msg}")
    return not failures
