"""Loss functions — port of `deeplearning4j_tpu/nn/losses.py`.

Conventions as in the JAX package: `preout` is the PRE-activation output
of the output layer ([batch, ..., n_out]); the loss applies the output
activation itself, so softmax + MCXENT and sigmoid + XENT use their
stable fused forms. `mask` is an optional 0/1 array broadcastable to the
per-example score shape; masked rows leave the mean. Every loss returns
a scalar tensor: the mean over unmasked examples.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import Activation


def _reduce(per_example, mask: Optional[torch.Tensor]):
    """Mean over examples, honoring a 0/1 mask (mask applies to score
    rows)."""
    if mask is None:
        return per_example.mean()
    mask = torch.broadcast_to(torch.as_tensor(mask, device=per_example.device),
                              per_example.shape).to(per_example.dtype)
    total = (per_example * mask).sum()
    denom = torch.clamp(mask.sum(), min=1.0)
    return total / denom


def _sum_features(x):
    return x.sum(dim=-1)


def _apply_act(preout, activation):
    return Activation.get(activation)(preout)


def _weighted(x, weights):
    if weights is None:
        return x
    return x * torch.as_tensor(weights, dtype=x.dtype, device=x.device)


def mcxent(labels, preout, activation="softmax", mask=None, weights=None):
    """Multi-class cross entropy; fused log-softmax when
    activation='softmax'. Soft labels and per-class `weights` work."""
    if str(activation).lower() in ("softmax", "logsoftmax"):
        logp = torch.log_softmax(preout, dim=-1)
    else:
        p = _apply_act(preout, activation)
        logp = torch.log(torch.clamp(p, 1e-10, 1.0))
    ll = _weighted(labels * logp, weights)
    return _reduce(-_sum_features(ll), mask)


def negativeloglikelihood(labels, preout, activation="softmax", mask=None,
                          weights=None):
    """Identical math to MCXENT, as in DL4J."""
    return mcxent(labels, preout, activation, mask, weights)


def sparse_mcxent(labels, preout, activation="softmax", mask=None):
    """Integer-label cross entropy (no one-hot)."""
    logp = torch.log_softmax(preout, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _reduce(-ll, mask)


def xent(labels, preout, activation="sigmoid", mask=None, weights=None):
    """Binary cross entropy; fused stable form when activation='sigmoid'."""
    if str(activation).lower() == "sigmoid":
        per_feat = labels * F.softplus(-preout) \
            + (1.0 - labels) * F.softplus(preout)
    else:
        p = torch.clamp(_apply_act(preout, activation), 1e-7, 1.0 - 1e-7)
        per_feat = -(labels * torch.log(p)
                     + (1.0 - labels) * torch.log(1.0 - p))
    return _reduce(_sum_features(_weighted(per_feat, weights)), mask)


def mse(labels, preout, activation="identity", mask=None, weights=None):
    """Mean over features of squared error."""
    d = _weighted((_apply_act(preout, activation) - labels) ** 2, weights)
    return _reduce(d.mean(dim=-1), mask)


def l2(labels, preout, activation="identity", mask=None):
    """Sum over features of squared error."""
    out = _apply_act(preout, activation)
    return _reduce(_sum_features((out - labels) ** 2), mask)


def l1(labels, preout, activation="identity", mask=None):
    """Sum of absolute error."""
    out = _apply_act(preout, activation)
    return _reduce(_sum_features((out - labels).abs()), mask)


def mae(labels, preout, activation="identity", mask=None):
    """Mean absolute error over features."""
    out = _apply_act(preout, activation)
    return _reduce((out - labels).abs().mean(dim=-1), mask)


def mape(labels, preout, activation="identity", mask=None):
    out = _apply_act(preout, activation)
    pct = ((labels - out) / torch.clamp(labels.abs(), min=1e-8)).abs() \
        * 100.0
    return _reduce(pct.mean(dim=-1), mask)


def msle(labels, preout, activation="identity", mask=None):
    """Mean squared log error."""
    out = _apply_act(preout, activation)
    d = torch.log1p(torch.clamp(out, min=0.0)) \
        - torch.log1p(torch.clamp(labels, min=0.0))
    return _reduce((d * d).mean(dim=-1), mask)


def hinge(labels, preout, activation="identity", mask=None):
    """Labels in {-1, +1}."""
    out = _apply_act(preout, activation)
    return _reduce(_sum_features(torch.clamp(1.0 - labels * out, min=0.0)),
                   mask)


def squared_hinge(labels, preout, activation="identity", mask=None):
    out = _apply_act(preout, activation)
    h = torch.clamp(1.0 - labels * out, min=0.0)
    return _reduce(_sum_features(h * h), mask)


def kl_divergence(labels, preout, activation="softmax", mask=None):
    """KL(labels || model)."""
    out = torch.clamp(_apply_act(preout, activation), 1e-10, 1.0)
    lab = torch.clamp(labels, 1e-10, 1.0)
    return _reduce(_sum_features(lab * (torch.log(lab) - torch.log(out))),
                   mask)


def poisson(labels, preout, activation="identity", mask=None):
    """sum(pred - label * log(pred))."""
    out = torch.clamp(_apply_act(preout, activation), min=1e-10)
    return _reduce(_sum_features(out - labels * torch.log(out)), mask)


def cosine_proximity(labels, preout, activation="identity", mask=None):
    """Negative cosine similarity."""
    out = _apply_act(preout, activation)
    dot = _sum_features(labels * out)
    norm = torch.sqrt(_sum_features(labels * labels)
                      * _sum_features(out * out) + 1e-12)
    return _reduce(-dot / norm, mask)


def wasserstein(labels, preout, activation="identity", mask=None):
    """Critic loss: mean(label * pred)."""
    out = _apply_act(preout, activation)
    return _reduce((labels * out).mean(dim=-1), mask)


_REGISTRY: Dict[str, Callable] = {
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "sparse_mcxent": sparse_mcxent,
    "xent": xent,
    "binary_xent": xent,
    "mse": mse,
    "squared_loss": mse,
    "l1": l1,
    "l2": l2,
    "mae": mae,
    "mean_absolute_error": mae,
    "mape": mape,
    "mean_absolute_percentage_error": mape,
    "msle": msle,
    "mean_squared_logarithmic_error": msle,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "wasserstein": wasserstein,
}


class LossFunction:
    """Enum-like accessor mirroring the JAX package's `LossFunction`."""

    MCXENT = "mcxent"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    SPARSE_MCXENT = "sparse_mcxent"
    XENT = "xent"
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    MAE = "mae"
    MAPE = "mape"
    MSLE = "msle"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    POISSON = "poisson"
    COSINE_PROXIMITY = "cosine_proximity"
    WASSERSTEIN = "wasserstein"

    @staticmethod
    def get(name_or_fn: Union[str, Callable]) -> Callable:
        if callable(name_or_fn):
            return name_or_fn
        key = str(name_or_fn).lower()
        if key not in _REGISTRY:
            raise ValueError(f"Unknown loss {name_or_fn!r}; known: "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[key]

    @staticmethod
    def register(name: str, fn: Callable) -> None:
        """Custom-loss plug-in seam."""
        _REGISTRY[name.lower()] = fn

    @staticmethod
    def names():
        return sorted(_REGISTRY)


def resolve(name_or_fn) -> Callable:
    return LossFunction.get(name_or_fn)
