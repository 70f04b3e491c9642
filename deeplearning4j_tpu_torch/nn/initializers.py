"""Weight initialization — the port's own seeded init (counterpart of
`deeplearning4j_tpu/nn/initializers.py`).

Same schemes and fan conventions as the JAX package (a dense kernel
[n_in, n_out] has fan_in = n_in), drawn from an explicit
`torch.Generator`. Torch and JAX streams differ, so a port net seeded
like a JAX net does NOT get the same weights: parity tests carry the JAX
parameters across (`models.convert.params_from_numpy`). The seeded init
here is for running the port on its own, as `chip_smoke.py` does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple, Union

import torch


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return receptive * shape[-2], receptive * shape[-1]


def _normal(gen, shape, dtype):
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32
                       ).to(dtype)


def _uniform(gen, shape, dtype, a):
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return ((2.0 * u - 1.0) * a).to(dtype)


def zeros(gen, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype)


def ones(gen, shape, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype)


def normal(gen, shape, dtype=torch.float32):
    """N(0, 1/sqrt(fan_in))."""
    fan_in, _ = _fans(shape)
    return _normal(gen, shape, dtype) / math.sqrt(fan_in)


def uniform(gen, shape, dtype=torch.float32):
    """U[-a, a], a = 1/sqrt(fan_in)."""
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, dtype, 1.0 / math.sqrt(max(fan_in, 1)))


def xavier(gen, shape, dtype=torch.float32):
    """N(0, 2/(fan_in+fan_out))."""
    fan_in, fan_out = _fans(shape)
    return _normal(gen, shape, dtype) * math.sqrt(
        2.0 / max(fan_in + fan_out, 1))


def xavier_uniform(gen, shape, dtype=torch.float32):
    """U[-a, a], a = sqrt(6/(fan_in+fan_out))."""
    fan_in, fan_out = _fans(shape)
    return _uniform(gen, shape, dtype,
                    math.sqrt(6.0 / max(fan_in + fan_out, 1)))


def relu_init(gen, shape, dtype=torch.float32):
    """He: N(0, 2/fan_in)."""
    fan_in, _ = _fans(shape)
    return _normal(gen, shape, dtype) * math.sqrt(2.0 / max(fan_in, 1))


def xavier_fan_in(gen, shape, dtype=torch.float32):
    """N(0, 1/fan_in)."""
    fan_in, _ = _fans(shape)
    return _normal(gen, shape, dtype) / math.sqrt(max(fan_in, 1))


def relu_uniform(gen, shape, dtype=torch.float32):
    """U[-a, a], a = sqrt(6/fan_in)."""
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, dtype, math.sqrt(6.0 / max(fan_in, 1)))


def sigmoid_uniform(gen, shape, dtype=torch.float32):
    """U[-a, a], a = 4*sqrt(6/(fan_in+fan_out))."""
    fan_in, fan_out = _fans(shape)
    return _uniform(gen, shape, dtype,
                    4.0 * math.sqrt(6.0 / max(fan_in + fan_out, 1)))


def lecun_normal(gen, shape, dtype=torch.float32):
    """N(0, 1/fan_in)."""
    fan_in, _ = _fans(shape)
    return _normal(gen, shape, dtype) * math.sqrt(1.0 / max(fan_in, 1))


def lecun_uniform(gen, shape, dtype=torch.float32):
    """U[-a, a], a = sqrt(3/fan_in)."""
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, dtype, math.sqrt(3.0 / max(fan_in, 1)))


def identity_init(gen, shape, dtype=torch.float32):
    """The identity matrix (square 2-D shapes only)."""
    if len(shape) == 2 and shape[0] == shape[1]:
        return torch.eye(shape[0], dtype=dtype)
    raise ValueError(f"IDENTITY init needs a square 2-D shape, got {shape}")


def orthogonal(gen, shape, dtype=torch.float32):
    """Orthonormal rows or columns (whichever are fewer), from the QR
    factor of a seeded normal matrix with the sign of R's diagonal."""
    rows, cols = math.prod(shape[:-1]), shape[-1]
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.reshape(tuple(shape)).to(dtype)


def _truncated_normal(gen, shape):
    """Standard normal draws truncated to (-2, 2), by the inverse CDF of
    uniforms on (Phi(-2), Phi(2)), as `jax.random.truncated_normal`."""
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return torch.clamp(z, -2.0, 2.0)


def distribution(dist: str = "normal", **kw) -> Callable:
    """WeightInit.DISTRIBUTION: an initializer drawing every element from
    one law, as the JAX package's `distribution`: normal (or gaussian)
    (mean, std), uniform(lower, upper), constant(value),
    truncated_normal(mean, std) (the standard normal cut at +-2 std),
    lognormal(mean, std) (exp of a normal) and binomial(n, p) (the sum of
    n Bernoulli(p) draws). Draws come from the explicit generator."""
    d = dist.lower()
    mean, std = kw.get("mean", 0.0), kw.get("std", 1.0)

    def init(gen, shape, dtype=torch.float32):
        shape = tuple(shape)
        if d in ("normal", "gaussian"):
            return (mean + std * _normal(gen, shape, torch.float64)).to(dtype)
        if d == "uniform":
            lo, hi = kw.get("lower", -1.0), kw.get("upper", 1.0)
            u = torch.rand(shape, generator=gen, dtype=torch.float64)
            return (lo + (hi - lo) * u).to(dtype)
        if d == "constant":
            return torch.full(shape, kw.get("value", 0.0), dtype=dtype)
        if d == "truncated_normal":
            return (mean + std * _truncated_normal(gen, shape)).to(dtype)
        if d == "lognormal":
            return torch.exp(mean + std * _normal(gen, shape,
                                                  torch.float64)).to(dtype)
        if d == "binomial":
            n, p = int(kw.get("n", 1)), kw.get("p", 0.5)
            u = torch.rand(shape + (n,), generator=gen, dtype=torch.float64)
            return (u < p).sum(-1).to(dtype)
        raise ValueError(f"Unknown distribution {dist!r}")

    init.__name__ = f"distribution_{d}"
    return init


_REGISTRY: Dict[str, Callable] = {
    "zero": zeros,
    "zeros": zeros,
    "ones": ones,
    "normal": normal,
    "uniform": uniform,
    "xavier": xavier,
    "xavier_uniform": xavier_uniform,
    "xavier_fan_in": xavier_fan_in,
    "relu": relu_init,
    "he": relu_init,
    "relu_uniform": relu_uniform,
    "sigmoid_uniform": sigmoid_uniform,
    "lecun_normal": lecun_normal,
    "lecun_uniform": lecun_uniform,
    "identity": identity_init,
    "orthogonal": orthogonal,
}


class WeightInit:
    """Name lookup and constants mirroring the JAX package's
    `WeightInit` (DL4J's `WeightInit` enum)."""

    ZERO = "zero"
    ONES = "ones"
    NORMAL = "normal"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    IDENTITY = "identity"
    ORTHOGONAL = "orthogonal"
    DISTRIBUTION = "distribution"

    @staticmethod
    def get(name_or_fn: Union[str, Callable, None]) -> Callable:
        if name_or_fn is None:
            return xavier
        if callable(name_or_fn):
            return name_or_fn
        key = str(name_or_fn).lower()
        if key not in _REGISTRY:
            raise ValueError(
                f"Unknown weight init {name_or_fn!r}; known: "
                f"{sorted(_REGISTRY)}")
        return _REGISTRY[key]

    @staticmethod
    def register(name: str, fn: Callable) -> None:
        """Add a custom initializer `fn(gen, shape, dtype)` under
        `name` (lower-cased)."""
        _REGISTRY[name.lower()] = fn


def resolve(name_or_fn) -> Callable:
    return WeightInit.get(name_or_fn)
