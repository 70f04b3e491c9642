"""Learning-rate schedules — port of `deeplearning4j_tpu/optim/schedules.py`.

A schedule is `value(step) -> tensor`, a pure function of the iteration
counter. `step` may be a Python number or a tensor on the device (the
train step passes the device step counter), so the learning rate is
computed where it is used and never read back to the host. The classes
carry the JAX package's serde names and fields, so a JAX configuration's
schedule loads as the port's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from deeplearning4j_tpu_torch.utils.serde import register_serde


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


class Schedule:
    """Base: subclasses implement value(step) with torch math."""

    def value(self, step):
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@schedule"] = type(self).__name__
        return d


@register_serde
@dataclasses.dataclass(frozen=True)
class FixedSchedule(Schedule):
    value_: float

    def value(self, step):
        return torch.full_like(_f32(step), self.value_)


@register_serde
@dataclasses.dataclass(frozen=True)
class StepSchedule(Schedule):
    """lr * decay_rate^floor(step / step_size)."""
    initial: float
    decay_rate: float
    step_size: float

    def value(self, step):
        return self.initial * torch.pow(
            self.decay_rate, torch.floor(_f32(step) / self.step_size))


@register_serde
@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(Schedule):
    """lr * decay_rate^step."""
    initial: float
    decay_rate: float

    def value(self, step):
        return self.initial * torch.pow(self.decay_rate, _f32(step))


@register_serde
@dataclasses.dataclass(frozen=True)
class InverseSchedule(Schedule):
    """lr / (1 + gamma*step)^power."""
    initial: float
    gamma: float
    power: float

    def value(self, step):
        return self.initial / (1.0 + self.gamma * _f32(step)) ** self.power


@register_serde
@dataclasses.dataclass(frozen=True)
class PolySchedule(Schedule):
    """lr * (1 - step/max_iter)^power."""
    initial: float
    power: float
    max_iter: int

    def value(self, step):
        frac = torch.clamp(_f32(step) / self.max_iter, 0.0, 1.0)
        return self.initial * (1.0 - frac) ** self.power


@register_serde
@dataclasses.dataclass(frozen=True)
class SigmoidSchedule(Schedule):
    """lr / (1 + exp(-gamma*(step - center)))."""
    initial: float
    gamma: float
    center: int

    def value(self, step):
        return self.initial / (
            1.0 + torch.exp(-self.gamma * (_f32(step) - self.center)))


@register_serde
@dataclasses.dataclass(frozen=True)
class MapSchedule(Schedule):
    """Piecewise-constant from {iteration: lr}, branch-free."""
    initial: float
    schedule: Dict[int, float] = dataclasses.field(default_factory=dict)

    def value(self, step):
        # keys may be str after a JSON round-trip; compare numerically
        s = _f32(step)
        lr = torch.full_like(s, self.initial)
        for k in sorted(self.schedule, key=lambda k: int(k)):
            lr = torch.where(s >= int(k),
                             torch.full_like(s, self.schedule[k]), lr)
        return lr


@register_serde
@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule(Schedule):
    """Linear warmup then cosine decay."""
    peak: float
    warmup_steps: int
    total_steps: int
    final: float = 0.0

    def value(self, step):
        s = _f32(step)
        warm = self.peak * s / max(self.warmup_steps, 1)
        frac = torch.clamp(
            (s - self.warmup_steps)
            / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = self.final + 0.5 * (self.peak - self.final) * (
            1.0 + torch.cos(math.pi * frac))
        return torch.where(s < self.warmup_steps, warm, cos)


def as_schedule(lr) -> Schedule:
    if isinstance(lr, Schedule):
        return lr
    return FixedSchedule(float(lr))
