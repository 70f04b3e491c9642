"""Parameter-tree helpers: DL4J's flat parameter view over the port's
nested dicts of tensors (port of `deeplearning4j_tpu/utils/pytrees.py`).

DL4J keeps every parameter of a network in one flat vector
(`Model.params()`); the port keeps a dict of per-layer dicts of tensors,
as the JAX package keeps its pytree, and builds the flat view on demand.
The flat order is `jax.flatten_util.ravel_pytree`'s: dict keys sorted,
depth first, each leaf raveled row-major; so a dense net's `params()`
here equals the JAX net's element for element, and a vector from either
package loads into the other.

Every leaf has the JAX layout, so the flat vectors agree for every
layer the port has, convolutions included: the port stores a
convolution kernel as JAX does, HWIO `[kh, kw, c_in, c_out]`, and
transposes it to PyTorch's OIHW only inside the forward.

`copy_flat_` writes a flat vector into a tree IN PLACE (`copy_`): the
CUDA graphs of `fit(steps_per_dispatch=K)` and of the stepping calls
read every parameter where they were captured, so a leaf is never
rebound.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def ravel_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of nested dicts in the flat order (keys sorted, depth
    first), the order of `flatten_params`; `()` and `None` hold no leaf.
    `optim/updaters.tree_leaves` walks the keys in insertion order
    instead: never zip one list with the other."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in ravel_leaves(tree[k])]
    if tree is None or (isinstance(tree, tuple) and not tree):
        return []
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of nested dicts (and of the trees `rest` of
    the same structure); `()` and `None` pass through. The port's one
    tree map (the updaters and the runtimes use it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if tree is None or (isinstance(tree, tuple) and not tree):
        return tree
    return fn(tree, *rest)


def _flat_dtype(leaves) -> torch.dtype:
    if not leaves:
        return torch.float32
    return functools.reduce(torch.promote_types, (t.dtype for t in leaves))


def flatten_params(tree: Any) -> Tuple[torch.Tensor, Callable]:
    """(flat 1-D tensor, unravel). The vector is a new tensor in the
    leaves' promoted dtype on their device; `unravel(v)` gives a tree of
    the same structure whose leaves are views of `v` in each leaf's
    dtype and shape (differentiable: the solvers take gradients through
    it)."""
    leaves = ravel_leaves(tree)
    dt = _flat_dtype(leaves)
    if leaves:
        flat = torch.cat([t.detach().reshape(-1).to(dt) for t in leaves])
    else:
        flat = torch.zeros((0,), dtype=dt)
    return flat, functools.partial(unflatten_params, like=tree)


def unflatten_params(flat: torch.Tensor, like: Any) -> Any:
    """The tree `like` rebuilt from the flat vector `flat`, its leaves
    slices of `flat` (cast where a leaf's dtype differs)."""
    n = param_count(like)
    if flat.ndim != 1 or flat.shape[0] != n:
        raise ValueError(f"flat vector of shape {tuple(flat.shape)} for a "
                         f"tree of {n} parameters")
    offsets = {}
    pos = 0
    for t in ravel_leaves(like):
        offsets[id(t)] = pos
        pos += t.numel()

    def leaf(t):
        o = offsets[id(t)]
        v = flat[o:o + t.numel()].reshape(t.shape)
        return v if v.dtype == t.dtype else v.to(t.dtype)

    return tree_map(leaf, like)


@torch.no_grad()
def copy_flat_(tree: Any, flat) -> Any:
    """Copy the flat vector (a tensor or an array) into the leaves of
    `tree` in place, in the flat order; returns `tree`."""
    leaves = ravel_leaves(tree)
    n = sum(t.numel() for t in leaves)
    if not isinstance(flat, torch.Tensor):
        flat = torch.tensor(np.asarray(flat))
    if flat.ndim != 1 or flat.shape[0] != n:
        raise ValueError(f"flat vector of shape {tuple(flat.shape)} for a "
                         f"tree of {n} parameters")
    pos = 0
    for t in leaves:
        t.copy_(flat[pos:pos + t.numel()].reshape(t.shape))
        pos += t.numel()
    return tree


def param_count(tree: Any) -> int:
    """Reference: `Model.numParams()`."""
    return sum(math.prod(t.shape) for t in ravel_leaves(tree))


def tree_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm over every leaf, in float32 (0 for an empty
    tree)."""
    leaves = ravel_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum((t.float() ** 2).sum() for t in leaves))


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda t: t * s, tree)


def tree_to_numpy(tree: Any) -> Any:
    """Leaves as host numpy arrays (bfloat16 as float32)."""
    def host(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return tree_map(host, tree)
