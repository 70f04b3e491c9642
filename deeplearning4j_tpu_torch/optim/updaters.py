"""Gradient updaters — port of `deeplearning4j_tpu/optim/updaters.py`.

ND4J semantics, not `torch.optim`'s: Adam puts ε outside the
bias-corrected square root (update = lr·bc·m / (√v + ε), bc =
√(1-β2^t) / (1-β1^t)), and Nesterovs is v' = μv - lr·g,
p' = p + μv' - lr·g. The classes keep the JAX package's serde names and
fields, so a JAX configuration's updater loads as the port's.

Trees are nested dicts of tensors keyed like the params tree; stateless
updaters keep `()` as their state, as in JAX. API:
``state = u.init(params)``; ``updates, state = u.apply(grads, state,
params, step)`` (not on Adam and Nesterovs, whose arithmetic is only in
their kernels' plain versions); and the one seam the train step calls,
``params, state = u.update_with_params(grads, state, params, step)``,
which updates params and state IN PLACE (JAX donates them; the TPU
kernel aliases them) and returns the same trees. `step` is the 0-based
iteration, a tensor on the params' device in the train step, so a
schedule's learning rate and Adam's bias correction are computed there
and never read back to the host.

`Adam.update_with_params` and `Nesterovs.update_with_params` go
through the fused kernels B1a and B1b: one launch a dtype group for
every leaf of the trees they are given, the kernels' plain versions on
CPU tensors. They keep a launch plan a leaf set
(`ops/fused_update.leaf_plans`: checked once, valid while every p, m and
v is the tensor it was built on), so a step reads the gradient tree and
nothing else of the trees; on the card Adam's bias-corrected rate comes
from the step counter in one launch (`fused_update.adam_lrbc`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import torch

from deeplearning4j_tpu_torch.optim.schedules import (
    FixedSchedule, Schedule, as_schedule,
)
from deeplearning4j_tpu_torch.utils.pytrees import tree_map
from deeplearning4j_tpu_torch.utils.serde import register_serde


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of nested dicts in key (insertion) order, the order the
    fused updates and the graphs walk; `utils/pytrees.ravel_leaves` is
    the flat parameter view's sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple) and not tree:
        return []
    return [tree]


def _step_f32(step, like) -> torch.Tensor:
    return torch.as_tensor(step, device=like.device).to(torch.float32)


def _first_leaf(tree):
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("an updater needs at least one parameter")
    return leaves[0]


def _lr(self, step):
    return as_schedule(self.learning_rate).value(step)


def _constant_lr(self):
    """The learning rate as a float where it is constant, else None."""
    lr = self.learning_rate
    if isinstance(lr, FixedSchedule):
        return lr.value_
    return None if isinstance(lr, Schedule) else float(lr)


class Updater:
    """Base updater. Subclasses are frozen dataclasses (JSON-serializable).

    `sharded_state` names the state keys that are param-shaped moments."""

    sharded_state = ()

    def init(self, params) -> Any:
        return ()

    def apply(self, grads, state, params, step):
        raise NotImplementedError

    def update_with_params(self, grads, state, params, step):
        """The whole optimizer step as ONE seam, in place: params -=
        apply(...)'s updates (cast to each param's dtype, as JAX casts)
        and the new state copied into the old. Returns (params, state)."""
        upd, st = self.apply(grads, state, params, step)
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(upd)):
                p.sub_(u.to(p.dtype))
            for old, new in zip(tree_leaves(state), tree_leaves(st)):
                if new is not old:
                    old.copy_(new)
        return params, state

    lr = _lr


@register_serde
@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    """Frozen layers use this."""

    def apply(self, grads, state, params, step):
        return tree_map(torch.zeros_like, grads), state

    def update_with_params(self, grads, state, params, step):
        return params, state


@register_serde
@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    """update = lr * g."""
    learning_rate: Any = 1e-3

    def apply(self, grads, state, params, step):
        lr = self.lr(_step_f32(step, _first_leaf(grads)))
        return tree_map(lambda g: lr * g, grads), state


@register_serde
@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    """ND4J NesterovsUpdater: v' = mu*v - lr*g; params += mu*v' - lr*g."""
    learning_rate: Any = 0.1
    momentum: float = 0.9
    sharded_state = ("v",)

    def init(self, params):
        return {"v": tree_map(torch.zeros_like, params)}

    def update_with_params(self, grads, state, params, step):
        """One fused read-modify-write of every leaf (kernel B1b): one
        launch a dtype on the card, the plain version on the CPU. The
        arithmetic lives only there (`ops/fused_update`), so Nesterovs
        has no separate `apply`."""
        from deeplearning4j_tpu_torch.ops import fused_update as fu

        plans = fu.leaf_plans("nesterov", params, None, state["v"])
        lr = _constant_lr(self)
        if lr is None:
            lr = torch.as_tensor(self.lr(_step_f32(step, plans)),
                                 dtype=torch.float32, device=plans.device)
        else:
            lr = plans.constant(lr)
        plans.run(plans.grads(grads), lr, momentum=self.momentum)
        return params, state


@register_serde
@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    """AdamUpdater (bias-corrected moments, ε outside the square root)."""
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    sharded_state = ("m", "v")

    def init(self, params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    def update_with_params(self, grads, state, params, step):
        """One fused read-modify-write of every leaf (kernel B1a): one
        launch a dtype on the card, the plain version on the CPU. Adam's
        arithmetic lives only there (`ops/fused_update`), so Adam has no
        separate `apply`."""
        from deeplearning4j_tpu_torch.ops import fused_update as fu

        plans = fu.leaf_plans("adam", params, state["m"], state["v"])
        lr = _constant_lr(self)
        if lr is None:              # a schedule's rate at this step
            lr = self.lr(_step_f32(step, plans) + 1.0 - 1.0)
        lrbc = plans.adam_lrbc(step, lr, self.beta1, self.beta2)
        plans.run(plans.grads(grads), lrbc, beta1=self.beta1,
                  beta2=self.beta2, eps=self.epsilon)
        return params, state


@register_serde
@dataclasses.dataclass(frozen=True)
class AdaMax(Updater):
    """Infinity-norm Adam variant."""
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    sharded_state = ("m", "u")

    def init(self, params):
        return {"m": tree_map(torch.zeros_like, params),
                "u": tree_map(torch.zeros_like, params)}

    def apply(self, grads, state, params, step):
        t = _step_f32(step, _first_leaf(grads)) + 1.0
        lr = self.lr(t - 1.0)
        b1 = self.beta1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        u = tree_map(lambda u, g: torch.maximum(self.beta2 * u, g.abs()),
                     state["u"], grads)
        scale = lr / (1.0 - b1 ** t)
        updates = tree_map(lambda m, u: scale * m / (u + self.epsilon), m, u)
        return updates, {"m": m, "u": u}


@register_serde
@dataclasses.dataclass(frozen=True)
class Nadam(Updater):
    """Nesterov-accelerated Adam."""
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    sharded_state = ("m", "v")

    def init(self, params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    def apply(self, grads, state, params, step):
        t = _step_f32(step, _first_leaf(grads)) + 1.0
        lr = self.lr(t - 1.0)
        b1, b2 = self.beta1, self.beta2
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                     grads)
        mc = 1.0 - b1 ** t
        vc = 1.0 - b2 ** t
        updates = tree_map(
            lambda m, v, g: lr * (b1 * m / mc + (1 - b1) * g / mc)
            / (torch.sqrt(v / vc) + self.epsilon), m, v, grads)
        return updates, {"m": m, "v": v}


@register_serde
@dataclasses.dataclass(frozen=True)
class AMSGrad(Updater):
    """Adam with a non-decreasing v-hat."""
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    sharded_state = ("m", "v", "vhat")

    def init(self, params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "vhat": tree_map(torch.zeros_like, params)}

    def apply(self, grads, state, params, step):
        lr = self.lr(_step_f32(step, _first_leaf(grads)))
        b1, b2 = self.beta1, self.beta2
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                     grads)
        vhat = tree_map(torch.maximum, state["vhat"], v)
        updates = tree_map(
            lambda m, vh: lr * m / (torch.sqrt(vh) + self.epsilon), m, vhat)
        return updates, {"m": m, "v": v, "vhat": vhat}


@register_serde
@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    learning_rate: Any = 1e-1
    epsilon: float = 1e-6
    sharded_state = ("h",)

    def init(self, params):
        return {"h": tree_map(torch.zeros_like, params)}

    def apply(self, grads, state, params, step):
        lr = self.lr(_step_f32(step, _first_leaf(grads)))
        h = tree_map(lambda h, g: h + g * g, state["h"], grads)
        updates = tree_map(
            lambda g, h: lr * g / (torch.sqrt(h) + self.epsilon), grads, h)
        return updates, {"h": h}


@register_serde
@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    """rho/epsilon; no explicit learning rate."""
    rho: float = 0.95
    epsilon: float = 1e-6
    sharded_state = ("Eg", "Ex")

    def init(self, params):
        return {"Eg": tree_map(torch.zeros_like, params),
                "Ex": tree_map(torch.zeros_like, params)}

    def apply(self, grads, state, params, step):
        rho, eps = self.rho, self.epsilon
        Eg = tree_map(lambda a, g: rho * a + (1 - rho) * g * g, state["Eg"],
                      grads)
        updates = tree_map(
            lambda g, eg, ex: g * torch.sqrt(ex + eps) / torch.sqrt(eg + eps),
            grads, Eg, state["Ex"])
        Ex = tree_map(lambda a, u: rho * a + (1 - rho) * u * u, state["Ex"],
                      updates)
        return updates, {"Eg": Eg, "Ex": Ex}


@register_serde
@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    learning_rate: Any = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    sharded_state = ("g2",)

    def init(self, params):
        return {"g2": tree_map(torch.zeros_like, params)}

    def apply(self, grads, state, params, step):
        lr = self.lr(_step_f32(step, _first_leaf(grads)))
        d = self.rms_decay
        g2 = tree_map(lambda a, g: d * a + (1 - d) * g * g, state["g2"],
                      grads)
        updates = tree_map(
            lambda g, a: lr * g / (torch.sqrt(a) + self.epsilon), grads, g2)
        return updates, {"g2": g2}


#: every param-shaped moment key any built-in updater declares
MOMENT_STATE_KEYS = frozenset(
    k for cls in (Nesterovs, Adam, AdaMax, Nadam, AMSGrad, AdaGrad,
                  AdaDelta, RmsProp)
    for k in cls.sharded_state)


def resolve_updater(u) -> Updater:
    """Accept an Updater instance or a name string ('adam', 'sgd', ...)."""
    if isinstance(u, Updater):
        return u
    names = {
        "sgd": Sgd, "adam": Adam, "adamax": AdaMax, "nadam": Nadam,
        "amsgrad": AMSGrad, "nesterovs": Nesterovs, "adagrad": AdaGrad,
        "adadelta": AdaDelta, "rmsprop": RmsProp, "noop": NoOp, "none": NoOp,
    }
    key = str(u).lower()
    if key not in names:
        raise ValueError(f"Unknown updater {u!r}; known: {sorted(names)}")
    return names[key]()
